"""Distributed training (port of ``paddle_tpu/distributed``): the
one-device train step of ``hybrid``, the differentiable collectives of
``collective`` that the sequence-parallel path runs, the training
checkpoints of ``checkpoint`` and ``fleet.preemption``."""
