"""Training dispatch (port of ``paddle_tpu/jit``): ``loop`` so far."""
