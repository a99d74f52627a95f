"""Quantization core: ``qspec`` (QLayer), ``policy`` (MPQPolicy), the LSQ
``quantizer``, joint indicator training (``importance``) and the one-time
ILP search (``ilp``, ``search``)."""
