"""Test harnesses (port of ``paddle_tpu/testing``): the fault injectors
of the serving engines, the train step and the checkpoint IO layer."""
