"""CLI driver round trips (counterpart of the reference example.c)."""

import numpy as np

from pangulu_jax import cli
from pangulu_jax.io.mmio import write_matrix
from pangulu_jax.models import poisson2d


def _write_fixture(tmp_path):
    a = poisson2d(7)
    mtx = tmp_path / "a.mtx"
    write_matrix(mtx, a)
    rhs = tmp_path / "b.txt"
    np.savetxt(rhs, np.asarray(a.to_scipy() @ np.arange(1.0, a.n + 1)))
    return a, str(mtx), str(rhs)


def test_cli_solve_with_rhs(tmp_path, capsys):
    a, mtx, rhs = _write_fixture(tmp_path)
    rc = cli.main([
        "-f", mtx, "-nb", "16", "-r", rhs, "--dtype", "r64", "--check"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "solve residual" in out


def test_cli_save_load_factor(tmp_path, capsys):
    a, mtx, rhs = _write_fixture(tmp_path)
    fpath = str(tmp_path / "f.npz")
    assert cli.main(["-f", mtx, "-nb", "16", "--dtype", "r64",
                     "--save-factor", fpath]) == 0
    assert cli.main(["--load-factor", fpath, "-r", rhs,
                     "--dtype", "r64"]) == 0


def test_cli_requires_input(tmp_path):
    import pytest

    with pytest.raises(SystemExit):
        cli.main(["-nb", "16"])


def test_cli_load_factor_uses_checkpoint_dtype(tmp_path, capsys):
    """--load-factor must derive the rhs dtype from the checkpoint's
    saved opts_dtype, not the CLI --dtype default (r64)."""
    a, mtx, rhs = _write_fixture(tmp_path)
    fpath = str(tmp_path / "f32.npz")
    assert cli.main(["-f", mtx, "-nb", "16", "--dtype", "r32",
                     "--save-factor", fpath]) == 0
    # note: NO --dtype on the load run
    assert cli.main(["--load-factor", fpath, "-r", rhs]) == 0


def test_cli_load_factor_complex_embedded(tmp_path, capsys):
    """--load-factor on a complex-embedded checkpoint
    (complex_mode="embed"): a_origin is the 2n real embedding — the rhs and
    residual must be built for the ORIGINAL complex system."""
    import scipy.sparse as sp

    from pangulu_jax.api import InitOptions, finalize, gstrf, init
    from pangulu_jax.io.checkpoint import save_factor

    rng = np.random.default_rng(7)
    n = 40
    s = sp.random(n, n, density=0.15, random_state=rng,
                  dtype=np.float64)
    s = sp.csc_matrix(s + 1j * sp.random(n, n, density=0.15,
                                         random_state=rng)
                      + 4.0 * sp.eye(n))
    h = init(s, InitOptions(nb=16, dtype="cr64", complex_mode="embed",
                            ordering="rcm"))
    gstrf(h)
    fpath = str(tmp_path / "fc.npz")
    save_factor(h, fpath)
    finalize(h)
    rc = cli.main(["--load-factor", fpath])
    assert rc == 0
    out = capsys.readouterr().out
    assert "solve residual" in out
