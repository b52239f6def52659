"""Utility layer: enums, exceptions, checks, numeric helpers and data helpers."""
