"""The kinds of load loop, one module each, found by the traffic file's
``loop`` key (``chipbench.load.loop``)."""
