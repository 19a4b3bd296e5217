"""Crash-consistent checkpoint file IO (port of
``paddle_tpu/distributed/checkpoint``: the ``_io`` write path and the
integrity ``manifest``).  The live handoff's bundles are written
through it; the sharded model checkpoints of the JAX package are not
ported."""
