"""Model configurations (port of :mod:`repro.configs.base`).

A copy of the reference's frozen ``ModelConfig`` dataclass and its
registry: the port imports nothing of the JAX package, not even its
numpy-only modules.  One dataclass describes every architecture family
(dense / MoE / hybrid-recurrent / xLSTM / VLM / audio enc-dec) plus the
Zygarde "agile" (early-exit) settings; ``reduced()`` derives the small
CPU test variant (<=2 layers, d_model<=256, float32).  The port's model
(:mod:`repro_torch.models.transformer`) runs every family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# --------------------------------------------------------------------------- #
# Input shapes assigned to this paper.
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------- #
# Model configuration.
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ModelConfig:
    # identity -------------------------------------------------------------- #
    name: str
    family: str  # "dense" | "moe" | "hybrid" | "ssm" | "vlm" | "audio"
    source: str  # citation (paper / model card)

    # transformer dimensions ------------------------------------------------ #
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int = 0  # 0 => d_model // n_heads

    # MoE ------------------------------------------------------------------- #
    n_experts: int = 0  # 0 => dense FFN
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group_size: int = 512  # tokens per dispatch group

    # hybrid / recurrent ---------------------------------------------------- #
    # block pattern, repeated cyclically over layers; entries:
    #   "attn" | "rec" (RG-LRU) | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    rglru_width: int = 0  # 0 => d_model
    conv1d_width: int = 4

    # attention ------------------------------------------------------------- #
    window: int = 0  # 0 = full causal; >0 = sliding window (tokens)
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_chunk: int = 1024  # KV/query chunk for memory-efficient attention

    # encoder-decoder (audio) ------------------------------------------------ #
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    n_enc_tokens: int = 0  # frontend frames consumed by the encoder

    # modality frontend stub (VLM patches prepended to the LM sequence) ----- #
    n_frontend_tokens: int = 0

    # activation / norm ------------------------------------------------------ #
    act: str = "swiglu"  # "swiglu" | "gelu" | "relu2"
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # vocab padding (embedding/lm-head dims rounded up so the vocab dim is
    # both MXU-aligned and divisible by the 16-way model mesh axis; logits
    # over pad columns are trained-through, MaxText-style).  reduced() sets
    # this to 1 so smoke tests see exact shapes.
    vocab_pad: int = 128

    # nested remat of the attention op: backward recomputes the chunked
    # softmax instead of carrying ~S^2/2-sized f32 saves through the layer
    # scan (§Perf P1-H1); costs one extra attention forward per backward.
    remat_attention: bool = True

    # checkpoint granularity: one activation save per `remat_every` scanned
    # period-groups (k=4 cuts the 94-layer qwen3 save stack from 47 GiB to
    # 12 GiB per device at ~2x in-group recompute — §Perf P1-H2).
    remat_every: int = 4

    # gradient-accumulation splits of the global train batch; activation
    # temps scale with the microbatch (§Perf P1-H3 — how the 100B+ configs
    # fit train_4k in 16 GiB HBM).
    train_microbatches: int = 1

    # Zygarde agile (early-exit) settings ------------------------------------ #
    exit_every: int = 4  # one schedulable *unit* per this many layers
    mandatory_units: int = 1  # imprecise-computation mandatory prefix (units)
    n_clusters: int = 16  # k for the per-unit k-means classifier bank
    feature_dim: int = 128  # selected feature dims fed to the classifier
    utility_threshold: float = 0.1  # default margin threshold (per-unit at runtime)

    # shape coverage --------------------------------------------------------- #
    # How `long_500k` is supported:
    #   "native"  : sub-quadratic as-configured (SSM / hybrid local-attn)
    #   "window"  : lowered with an explicit sliding-window override
    #   "skip"    : documented skip (see DESIGN.md)
    long_context: str = "window"
    long_window: int = 4096  # window used when long_context == "window"

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad) * self.vocab_pad

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_rglru_width(self) -> int:
        return self.rglru_width or self.d_model

    @property
    def n_units(self) -> int:
        """Number of schedulable Zygarde units (layer groups)."""
        return -(-self.n_layers // self.exit_every)

    @property
    def resolved_mandatory_units(self) -> int:
        """Mandatory prefix clamped to [1, n_units] (a config whose layer
        count shrank — e.g. ``reduced()`` — keeps a valid prefix)."""
        return max(1, min(self.mandatory_units, self.n_units))

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % self.pattern_period]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, h = self.d_model, self.resolved_head_dim
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        total = emb + head
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            total += self._block_params(kind)
        if self.is_encoder_decoder:
            for i in range(self.n_enc_layers):
                total += self._block_params("attn")  # bidirectional enc block
                # decoder blocks additionally carry cross-attention
            total += self.n_layers * self._xattn_params()
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _xattn_params(self) -> int:
        return self._attn_params()

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.n_experts:
            per = self.d_ff * d * (3 if self.act == "swiglu" else 2)
            router = d * self.n_experts
            return self.n_experts * per + router
        mult = 3 if self.act == "swiglu" else 2
        return mult * d * self.d_ff

    def _block_params(self) -> int:  # pragma: no cover - overload shim
        raise TypeError

    def _block_params(self, kind: str) -> int:  # noqa: F811
        d = self.d_model
        norms = 2 * d
        if kind == "attn":
            return self._attn_params() + self._ffn_params() + norms
        if kind == "rec":
            w = self.resolved_rglru_width
            # in/out proj + block-diagonal gates (input & recurrence,
            # n_heads blocks — Griffin appendix A) + conv1d + Lambda
            gates = 2 * w * (w // self.n_heads)
            core = 2 * d * w + gates + self.conv1d_width * w + w
            return core + self._ffn_params() + norms
        if kind in ("mlstm", "slstm"):
            w = 2 * d  # internal up-projection factor 2
            qkv = 3 * d * w
            gates = 2 * d * w + 2 * w
            out = w * d
            return qkv + gates + out + norms
        raise ValueError(kind)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        per_expert = self.d_ff * self.d_model * (3 if self.act == "swiglu" else 2)
        inactive = self.n_layers * (self.n_experts - self.top_k) * per_expert
        return full - inactive

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family/topology, tiny dims."""
        period = self.pattern_period
        n_layers = max(2, period)  # keep at least one full pattern period
        if n_layers > 4:
            n_layers = period  # patterns longer than 4 keep one period
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # no token dropping in smoke variants: keeps the per-token output
            # independent of dispatch grouping (prefill/decode consistency)
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            rglru_width=min(self.resolved_rglru_width, d_model) if self.rglru_width else 0,
            window=min(self.window, 64) if self.window else 0,
            n_enc_layers=min(self.n_enc_layers, 2) if self.n_enc_layers else 0,
            n_enc_tokens=min(self.n_enc_tokens, 32) if self.n_enc_tokens else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16)
            if self.n_frontend_tokens
            else 0,
            exit_every=1,
            mandatory_units=1,
            n_clusters=4,
            feature_dim=min(self.feature_dim, 32),
            moe_group_size=64,
            attn_chunk=64,
            long_window=64,
            vocab_pad=1,
            train_microbatches=1,
            dtype="float32",
        )

    def with_window(self, window: int) -> "ModelConfig":
        """Sliding-window override used for the `long_500k` dense variant."""
        return dataclasses.replace(self, window=window)


# --------------------------------------------------------------------------- #
# Registry.
# --------------------------------------------------------------------------- #

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # lazy, avoids import cycles

    _load_all()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_configs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
