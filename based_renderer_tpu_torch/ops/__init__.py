"""Compute stages: fixed-point spec, clip, setup, binning, rasterization."""
