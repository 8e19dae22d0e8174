"""Port parity for K1's plain version at the full GR1T1 decimation (10
substeps per policy step), against the JAX ``lanes`` backend under jit, with
the tolerances of tests/test_torch_decimation.py (widened by the measured
float32 noise floor, which at 10 substeps reaches ~1e-4 rad/s in joint
velocity and ~1e-2 N in point forces)."""

import pytest

from test_torch_decimation import BOOL, PHYS_GROUPS, POST, case_with_floor, check_group


@pytest.fixture(scope="module")
def case():
    return case_with_floor(10)


@pytest.mark.parametrize("name", PHYS_GROUPS + ["post/" + k for k in POST])
def test_full_decimation_group_matches(case, name):
    check_group(case[:3], name)


def test_full_decimation_has_contacts(case):
    op = case[3]
    assert op.deci.decimation == 10
    assert float(case[1][8]["feet_contact"].sum()) >= 4
    assert BOOL <= {"post/" + k for k in POST}
