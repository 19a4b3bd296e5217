"""The ``paddle.nn`` surface of the port (port of ``paddle_tpu/nn``).

Only what a ported path needs is here so far: ``nn.functional.ctc_loss``.
The Layer API and the rest of ``nn.functional`` are still to be ported
(ROADMAP Queue 1 item 11).
"""
