"""Distributed-execution layer: so far the roofline step-cost model
(``roofline``), which sets the serving engine's prefill budget. The
sharding, collectives and mesh modules of the reference package come with
a later slice."""
