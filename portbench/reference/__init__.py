"""The plain reference: the language models' training step in plain
PyTorch, float32 with TF32 off (``precision="f32"``) or with every matrix
product's operands rounded to float8 e4m3 (``precision="fp8"``, the
control).  It imports nothing of ``repro_torch``, ``repro`` or ``jax``."""
