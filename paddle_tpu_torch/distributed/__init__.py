"""Distributed training (port of ``paddle_tpu/distributed``): the
one-device train step of ``hybrid`` so far."""
