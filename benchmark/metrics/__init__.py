"""Per-layer metric readers, one file each, found by the metric's name in
``BENCHMARK.json``: ``<name>.py`` if there is one, else the part of the
name before its first dot (``dispatch_share.bulk`` -> ``dispatch_share``).

A reader has ``WRAPS``, the port's callables whose host spans it needs
(``"module:Qualified.name"``, possibly empty), and ``read(ctx)``, which
returns the metric's value or None when the run holds nothing for it (no
span called, no device trace); the harness then leaves the metric out.
``ctx`` is :class:`benchmark.harness.Context`.
"""
