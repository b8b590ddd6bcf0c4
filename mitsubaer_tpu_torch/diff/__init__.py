"""Differentiable rendering (port of mitsubaer_tpu/diff): gradients of the
rendered image with respect to the medium parameters."""
