"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference this package is held against; this
package imports nothing from it (and never ``jax``).  Module paths mirror
``repro``'s, so each counterpart is found under the same name.
"""
