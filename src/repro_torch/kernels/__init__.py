"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` holds the public entry points (``fleet_priority``,
``fleet_fused_steps``, ``serve_fused_steps``, ``l1_topk2``,
``centroid_update``, ``pairwise_l1``, ``flash_attention``,
``decode_gqa``, ``rglru_scan``) and their launch counters;
``csrc/`` the CUDA sources, built by ``_build`` with ``nvcc`` for
``sm_90a`` at first use.  Each kernel module's ``work()`` gives one call's
bytes and operations, and ``_cost`` lets the op counter of
:mod:`repro_torch.launch.op_cost` count a call as one item of it.
Nothing here imports a compiler or touches a GPU at import time.
"""
