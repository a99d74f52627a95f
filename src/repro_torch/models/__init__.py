"""Config-driven LM (``lm``) and its building blocks."""
