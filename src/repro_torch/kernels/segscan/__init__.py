"""Tiled segmented-scan kernel (counterpart of ``segscan_pallas``)."""
