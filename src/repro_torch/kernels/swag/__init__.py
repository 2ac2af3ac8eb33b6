"""Fused sliding-window kernels: counterparts of ``swag_pallas``,
``sort_panes_pallas`` and ``swag_pallas_panes``."""
