"""Numeric ops: box geometry, anchors, NMS (kernel K1), ROI crop (kernel K2)."""
