"""``mrgcn_tpu_torch.__version__``: installed metadata, else the
repository's ``pyproject.toml``, else ``"0+unknown"``.

Reference fault (``ADVICE.md``): the JAX package's ``_version`` catches
only ``OSError``, so a ``pyproject.toml`` without ``[project].version``
or a malformed one breaks the import. The port's reads ``"0+unknown"``
there. The package's location is moved to a temporary directory and the
metadata lookup made to miss.
"""

import importlib.metadata

import pytest

import mrgcn_tpu_torch


@pytest.mark.parametrize("text,want", [
    ('[project]\nname = "mrgcn_tpu"\nversion = "9.8.7"\n', "9.8.7"),
    ('[project]\nname = "mrgcn_tpu"\n', "0+unknown"),
    ('[tool.other]\nkey = 1\n', "0+unknown"),
    ('[project\nversion = "1.0"\n', "0+unknown"),
    (None, "0+unknown"),
], ids=["version", "no_version", "no_project", "malformed", "no_file"])
def test_version_from_pyproject(text, want, tmp_path, monkeypatch):
    package = tmp_path / "mrgcn_tpu_torch"
    package.mkdir()
    if text is not None:
        (tmp_path / "pyproject.toml").write_text(text)

    def missing(name):
        raise importlib.metadata.PackageNotFoundError(name)

    monkeypatch.setattr(importlib.metadata, "version", missing)
    monkeypatch.setattr(mrgcn_tpu_torch, "__file__",
                        str(package / "__init__.py"))
    assert mrgcn_tpu_torch._version() == want
