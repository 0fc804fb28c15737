"""Every flag the reference hhblits parser accepts is handled by the
port's parser, and lands where the JAX package's parser puts it.

The flag list is tests/test_flag_coverage.py's ``REFERENCE_FLAGS``
(src/hhblits.cpp:414-820, extracted from its strcmp / strncmp calls),
imported so that the list has one source.
"""

import contextlib
import dataclasses
import io

import pytest

from test_flag_coverage import REFERENCE_FLAGS


def _parse(mod_args, mod_constants, argv):
    par = mod_constants.Parameters.hhblits_defaults()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        mod_args.parse_args(list(argv), par)
    return par, err.getvalue()


def _fields(par):
    return {f.name: getattr(par, f.name) for f in dataclasses.fields(par)
            if f.name != "argv"}


@pytest.mark.parametrize("flag", sorted(REFERENCE_FLAGS))
def test_reference_flag_is_parsed(flag):
    """The port consumes ``flag`` without the unknown-option warning and
    leaves every Parameters field as the JAX parser leaves it."""
    from hhsuite_tpu import constants as jax_constants
    from hhsuite_tpu.cli import args as jax_args

    from hhsuite_tpu_torch import args, constants

    value = REFERENCE_FLAGS[flag]
    argv = [flag] if value is None else [flag, value]
    par, err = _parse(args, constants, argv)
    assert "ignoring unknown option" not in err, \
        f"{flag} not handled: {err}"
    want, _ = _parse(jax_args, jax_constants, argv)
    assert _fields(par) == _fields(want)


def test_unknown_flag_is_reported():
    from hhsuite_tpu_torch import args, constants

    _par, err = _parse(args, constants, ["-no_such_flag"])
    assert "ignoring unknown option" in err
