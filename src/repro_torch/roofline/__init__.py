"""The dry-run's cost model of the port: the op-cost counter
(``roofline.costs``), the H100 roofline (``roofline.analysis``), the
report (``roofline.report``) and its debug view (``roofline.debug``)."""
