"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  decode_attention    flash-decode over padded variable-length compressed
                      KV caches (single token and fused Lq-token query);
                      the hot loop of Stretto's prefill-skip operators
  expected_attention  query-agnostic Expected-Attention compression scores
  prefill_attention   causal / windowed flash attention over whole
                      sequences (the offline prefill and calibration):
                      a tensor-core body for bfloat16, an FMA body for
                      float32
  beta_bounds         the planner's Beta credible bounds (kernel E):
                      betaincinv by bisection and its gradient's betainc
                      terms, one thread per element
  ref                 plain PyTorch versions of every kernel
  ops                 backend-selecting wrappers (auto | cuda | ref)
  build               nvcc + ctypes loader for csrc/*.cu

Importing this package compiles nothing; each kernel builds at its first
launch on the card.
"""
