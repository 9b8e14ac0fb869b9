"""Analytics units of the port: the bandit routers (``routers.py``). The
outlier detectors and explainers come with the analytics slice."""
