"""Fleet (port of ``paddle_tpu/distributed/fleet``): ``preemption`` so
far."""
