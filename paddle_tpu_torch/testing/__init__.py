"""Test harnesses (port of ``paddle_tpu/testing``): the serving engines'
device-fault injector."""
