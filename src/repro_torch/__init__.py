"""repro_torch — the Stretto execution engine ported to PyTorch and CUDA.

A second package beside the JAX reference `repro`; it imports neither
JAX nor `repro`. This slice carries the serving path below the planner:

  repro_torch.configs  — ModelConfig + stretto-llama-8b
  repro_torch.models   — the GQA decoder (prefill, decode, fused decode)
  repro_torch.data     — planted corpora and constructed weights
  repro_torch.cache    — Expected-Attention compression + npz CacheStore
  repro_torch.serving  — prefill-skip ServingEngine and its operators
  repro_torch.core     — logical / physical plan dataclasses
  repro_torch.runtime  — backends, dispatchers, streaming executor
  repro_torch.kernels  — hand-written CUDA kernels for Hopper (csrc/),
                         their plain PyTorch versions and the nvcc loader

Entry points take an explicit `device` (default "cuda") and raise when
CUDA is missing; tests pass device="cpu".
"""
__version__ = "0.1.0"
