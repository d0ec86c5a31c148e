"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The package mirrors ``repro``'s layout and module names. It imports neither
JAX nor anything of ``repro``: the few pure-Python modules it needs
(configs, the toy tokenizer) are its own copies. Every entry point runs on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and without
that request it raises instead of quietly running on the CPU.

This slice covers the dense family end to end: prefill + decode through the
hand-written flash-prefill and split-KV decode kernels, repeated sampling,
ProD targets, head training, and median/quantile inference through the fused
ProD-head kernel. See ``ROADMAP.md`` for what is still to port.
"""
