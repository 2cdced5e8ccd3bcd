"""Render pipeline: ray generation, wavefront bounce loop, shading."""
