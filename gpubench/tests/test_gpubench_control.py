"""The control: the plain reference one precision below the configuration
(PBA's interfaction coin against a bfloat16 probability; R-MAT's levels
drawn in 16 bits), put in the program's place, comes out not correct, at
a size a test run can hold. On the chip, ``gpubench/control.py`` reads it
at the cells' own sizes."""
import pytest

from gpubench import control


@pytest.mark.parametrize("cell", ["pba_t", "rmat_t", "pba_t2"])
@pytest.mark.parametrize("seed", [1, 2**31 + 11, 3 * 2**31])
def test_the_control_is_not_correct(tiny_bench, cell, seed):
    checks = control.control_checks(cell, seed, 40, "cpu", **tiny_bench)
    assert checks["digest_mismatch"]["value"] >= 1
    assert checks["failed_graphs"]["value"] == 0
    if cell == "rmat_t":
        assert checks["sampled_edges_wrong"]["value"] >= 1
