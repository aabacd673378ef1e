"""The paper's distribution schemes on a four-mode tensor against the
reference: ``test_torch_schemes.py``'s cases on the tensor with the paper
suite's enron-s skew and its hub on mode 0, in a file of their own (each
reference run compiles its four mode steps, about 11 s on the CPU). Bars as
there."""

import pytest

from test_torch_schemes import (CORE, SCHEMES, _four_mode,
                                check_scheme_against_reference)


@pytest.mark.parametrize("path", ["baseline", "liteopt"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_four_mode_scheme_matches_reference(scheme, path):
    check_scheme_against_reference(_four_mode(), CORE["four_mode"], scheme,
                                   path)
