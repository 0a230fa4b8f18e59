"""mrgcn_tpu_torch — the PyTorch and CUDA port of mrgcn_tpu for one NVIDIA
H100.

A second package beside the JAX reference: plain tensor code is PyTorch,
and every Pallas kernel of the reference becomes a kernel written by hand
for Hopper (``csrc/``, built at first use). Host code that imports no JAX
(config, artifact format, graph structure, feature setup) is the JAX
package's own and is imported from it, so both packages read the same
datasets. The port imports ``torch`` and never ``jax``.
"""

from mrgcn_tpu import __version__

__all__ = ["__version__"]
