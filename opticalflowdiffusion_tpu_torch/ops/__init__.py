"""Ops (JAX ``ops/``): conv, attention, splat and warp."""
