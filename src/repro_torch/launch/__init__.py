"""Serving drivers: scheduler, continuous-batching engine, ``serve`` CLI."""
