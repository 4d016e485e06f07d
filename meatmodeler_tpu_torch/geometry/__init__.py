"""Geometry building blocks (torch twins of ``meatmodeler_tpu/geometry``)."""
