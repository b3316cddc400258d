"""The port's copies of the archived kernel probes under ``benchmarks/``."""
