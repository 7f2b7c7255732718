"""Compute ops: rasterization, ROI-align, segment/group ops.

The hot, on-device counterparts of the reference's torchvision /
Panda3D / C++-extension calls.
"""
