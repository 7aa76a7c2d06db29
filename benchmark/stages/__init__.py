"""One module a stage entry of the program that a traffic mix can drive.

A stage module gives ``RATE`` (the end-to-end metric its passes report),
``SPANS`` (the layer calls the traced run wraps), ``prepare`` (the
generated inputs and the warm-up slice), ``run_pass``, ``pass_mbp``,
``OUTPUTS`` (the files a pass leaves that the check reads), ``check``
and ``PLANTS`` (the control and the faults, for ``benchmark.calibrate``
and the tests)."""
