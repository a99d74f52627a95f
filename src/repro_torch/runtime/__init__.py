"""Policy-driven mixed-precision serving runtime: ``packing`` (searched-grid
codes + bit-packing), ``kv_cache`` (int8 ring KV), ``dispatch`` (per-layer
kernel routes) and ``session`` (``QuantizedSession``)."""
