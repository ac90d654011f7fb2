"""TSDF fusion of rendered depth sweeps (host numpy thresholds, kernel T for
the integration)."""
