"""mrgcn_tpu_torch — the PyTorch and CUDA port of mrgcn_tpu for one NVIDIA
H100.

A second package beside the JAX reference: plain tensor code is PyTorch,
and every Pallas kernel of the reference becomes a kernel written by hand
for Hopper (``csrc/``, built at first use). Host code the run needs
(config, artifact format, graph structure, feature setup) is the port's
own copy of the JAX package's modules under the same relative names, so
both packages read the same datasets. The port imports ``torch`` and never
``jax`` nor ``mrgcn_tpu``.
"""


def _version() -> str:
    """The version both packages share: installed metadata first, then the
    repository's ``pyproject.toml`` (the package runs uninstalled from the
    repository root)."""
    from importlib.metadata import PackageNotFoundError, version
    try:
        return version("mrgcn_tpu")
    except PackageNotFoundError:
        pass
    import pathlib
    import tomllib
    pyproject = pathlib.Path(__file__).resolve().parent.parent \
        / "pyproject.toml"
    try:
        with open(pyproject, "rb") as f:
            return tomllib.load(f)["project"]["version"]
    except OSError:
        return "0+unknown"


__version__ = _version()

__all__ = ["__version__"]
