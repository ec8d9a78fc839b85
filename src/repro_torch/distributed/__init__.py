"""Distributed-optimization helpers. Only the one-device part is ported:
int8 gradient compression (``compression.py``). Logical axis rules, meshes
and collectives need the multi-device layer (ROADMAP A.10)."""
