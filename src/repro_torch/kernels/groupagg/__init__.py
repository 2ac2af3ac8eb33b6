"""Fused group-by-aggregate kernel (counterpart of ``groupagg_pallas``)."""
