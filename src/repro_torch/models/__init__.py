"""Decoder LM of the port: modules, attention, FFN, and the LM stack."""
