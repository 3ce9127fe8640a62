"""Run the card's test files under pytest on a machine with the card.

    python tests/card_pytest.py tests/test_torch_rpa_kernel.py tests/test_torch_flash_kernel.py

The card-side files import no JAX; ``tests/conftest.py`` does, so pytest
runs with ``--noconftest``. The port's test files import helpers as
``tests._torch_threads``, and an installed package named ``tests`` earlier
on the path (some distributions ship one) would shadow this folder, so the
name is bound to this folder before pytest starts. Arguments go to pytest.
"""

import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    pkg = types.ModuleType("tests")
    pkg.__path__ = [str(ROOT / "tests")]
    sys.modules["tests"] = pkg
    import pytest

    return pytest.main(["--noconftest", "-p", "no:cacheprovider", *argv])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
