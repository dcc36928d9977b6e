"""Training of the port's model zoo: the causal-LM step (`train_step`),
AdamW with int8 gradient compression (`optimizer`), atomic checkpoints
that the JAX package's `repro.training.checkpoint` reads and writes too
(`checkpoint`), and the fault-tolerant loop (`loop`). Plain torch on the
card or the CPU: the train path launches no kernel of `kernels.ops`."""
