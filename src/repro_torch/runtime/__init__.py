"""Serving runtime: prefill/decode steps and the BFC-admission-controlled
server (torch counterpart of `repro.runtime`'s serving slice)."""
