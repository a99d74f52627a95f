"""Quantization core: ``qspec`` (QLayer), ``policy`` (MPQPolicy) and the
forward half of the LSQ ``quantizer``."""
