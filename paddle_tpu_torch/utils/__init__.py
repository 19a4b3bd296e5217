"""Utilities (port of ``paddle_tpu/utils``): the retry policy the
serving engines' device calls run under."""
