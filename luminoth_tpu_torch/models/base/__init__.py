"""Backbones: ResNet v1 trunk and ROI tail."""
