"""Observability: the metrics registry behind ``EngineStats``."""
