"""Functional metrics: plain functions on tensors, computed on the inputs' device."""
