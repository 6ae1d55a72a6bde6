"""The entries into the program that a cell's traffic drives, one module
each, found by the traffic file's ``entry`` key
(``chipbench.manifest.entry``). An entry's ``Session(config, traffic,
seed, device, warm_all, hook)`` sets the system up and warms it, and gives
``reference_s``, ``start``, ``drive``, ``counters``, ``probe``, ``status``,
``stop``, ``describe``, ``close`` and ``check``."""
