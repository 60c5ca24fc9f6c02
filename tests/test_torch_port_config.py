"""flexflow_tpu_torch's FFConfig.parse_args and the uniform and normal
initializers against the JAX package's.

parse_args: every flag of the JAX package's parse_args is read (it
sets the same field to the same value as JAX's on the same argv), the
four once refused (--wd/-wd, -ll:cpu, --import/--import-strategy,
--iterations) included, from a list and from sys.argv; unknown arguments are
skipped; a config made under the test runner's own argv (pytest's, and
xdist's in its workers) has its defaults; --fusion from sys.argv reaches
compile(). The initializers are compared statistically, since the two
packages draw from different generators: over 200000 draws, the mean
within 5 standard errors of its expectation, the variance within 2%, and
a two-sample Kolmogorov-Smirnov test against JAX's draws at p > 1e-4.
"""
import dataclasses
import inspect
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import flexflow_tpu as jff
from flexflow_tpu.core import initializers as jinit
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch import config as tconfig
from flexflow_tpu_torch.core import initializers as tinit
from flexflow_tpu_torch.ff_types import LossType, OperatorType
from flexflow_tpu_torch.models import build_transformer

N = 200000


def _jax_flags():
    """Every flag spelling in the JAX package's parse_args."""
    src = inspect.getsource(jff.FFConfig.parse_args)
    return set(re.findall(r'"(-[^"\s]+)"', src))


def test_every_jax_flag_is_read_or_refused():
    """Every flag is read now: none is refused."""
    read = (set(tconfig._FLAGS) | set(tconfig._SWITCHES)
            | set(tconfig._SETTINGS))
    assert not hasattr(tconfig, "_UNPORTED_FLAGS")
    assert read == _jax_flags()
    fields = {f.name for f in dataclasses.fields(FFConfig)}
    for field, _ in tconfig._FLAGS.values():
        assert field is None or field in fields
    assert set(tconfig._SWITCHES.values()) <= fields
    for settings in tconfig._SETTINGS.values():
        assert set(settings) <= fields


def _changes(cfg, argv, shared):
    before = {f: getattr(cfg, f) for f in shared}
    cfg.parse_args(argv)
    return {f: getattr(cfg, f) for f in shared
            if getattr(cfg, f) != before[f]}


_ARGVS = [
    ["-b", "32"],
    ["-e", "3", "--batch-size", "8", "--epochs", "5"],
    ["--lr", "0.5", "-p", "10", "--fusion"],
    ["-lr", "0.25", "--print-freq", "7"],
    ["-b", "x", "-e", "2"],             # a bad value is read as a flag
    ["-b", "--fusion"],
    ["-e"],                             # a missing value
    ["--iterations-per-dispatch", "4", "--budget", "-1"],
    ["--search-budget", "3", "-ll:gpu", "1", "-ll:tpu", "2"],
    ["--unknown", "7", "-b", "16", "positional", "-x"],
    ["-p"],
    ["--fsdp-degree", "4", "-b", "8"],
    ["--no-overlap-backward-update"],
    ["--no-overlap-backward-update", "--overlap-backward-update"],
    ["--enable-sequence-parallel", "-b", "4"],
    ["--nodes", "2", "-ll:gpu", "4"],
]


@pytest.mark.parametrize("argv", _ARGVS, ids=" ".join)
def test_parse_args_sets_what_jax_sets(argv):
    shared = ({f.name for f in dataclasses.fields(FFConfig)}
              & {f.name for f in dataclasses.fields(jff.FFConfig)})
    got = _changes(FFConfig(device="cpu"), argv, shared)
    want = _changes(jff.FFConfig(), argv, shared)
    assert got == want


# the flags the port refused until its config took their fields, each
# with a value of its kind
_ONCE_REFUSED = {"--wd": "0.25", "-wd": "0.5", "-ll:cpu": "3",
                 "--import": "s.json", "--import-strategy": "t.json",
                 "--iterations": "7"}


@pytest.mark.parametrize("flag", sorted(_ONCE_REFUSED))
def test_unported_flags_raise_naming_the_flag(flag, monkeypatch):
    """The flags once refused: each now sets JAX's field to JAX's value,
    from an argv list (with a bad value after it too: the field stays)
    and from sys.argv at construction."""
    shared = ({f.name for f in dataclasses.fields(FFConfig)}
              & {f.name for f in dataclasses.fields(jff.FFConfig)})
    field = tconfig._FLAGS[flag][0]
    for argv in (["-b", "4", flag, _ONCE_REFUSED[flag]], [flag, "x"]):
        want = _changes(jff.FFConfig(), argv, shared)
        assert _changes(FFConfig(device="cpu"), argv, shared) == want
    assert field in _changes(jff.FFConfig(), [flag, _ONCE_REFUSED[flag]],
                             shared)
    monkeypatch.setattr(sys, "argv", ["prog", flag, _ONCE_REFUSED[flag]])
    assert getattr(FFConfig(device="cpu"), field) == \
        getattr(jff.FFConfig(), field)


def test_the_four_fields_have_jax_defaults():
    cfg, jcfg = FFConfig(device="cpu"), jff.FFConfig()
    for name in ("weight_decay", "cpusPerNode", "import_strategy_file",
                 "iterations"):
        assert getattr(cfg, name) == getattr(jcfg, name), name


def test_the_runners_own_argv_changes_no_field(monkeypatch):
    """This process's argv (pytest's, or an xdist worker's) and the test
    command's own arguments leave every field at its default."""
    live = FFConfig(device="cpu")
    monkeypatch.setattr(sys, "argv", ["prog"])
    clean = FFConfig(device="cpu")
    assert live == clean
    command_line = ["tests/", "-q", "-m", "not slow",
                    "--continue-on-collection-errors", "-p",
                    "no:cacheprovider", "-p", "xdist", "-n", "6", "--dist",
                    "loadfile", "--junitxml=report.xml", "-p", "no:randomly",
                    "-x", "-k", "torch_port", "--durations=10", "-rA"]
    cfg = FFConfig(device="cpu")
    cfg.parse_args(command_line)
    assert cfg == clean


def test_fusion_and_batch_from_argv_reach_compile(monkeypatch):
    """examples/python/nmt.py's way: FFConfig() reads sys.argv."""
    monkeypatch.setattr(sys, "argv", ["prog", "-b", "2", "--fusion",
                                      "--lr", "0.125"])
    cfg = FFConfig(device="cpu")
    assert (cfg.batch_size, cfg.perform_fusion, cfg.learning_rate) == \
        (2, True, 0.125)
    m = FFModel(cfg)
    build_transformer(m, cfg.batch_size, 4, 8, 2, 1)
    m.compile(loss_type=LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert [op.op_type for op in m.graph.ops] == \
        [OperatorType.OP_MULTIHEAD_ATTENTION, OperatorType.OP_FUSED]
    # no optimizer given: SGD at the config's rate, as in JAX
    assert m.optimizer.lr == 0.125


def test_new_fields_have_jax_defaults():
    cfg, jcfg = FFConfig(device="cpu"), jff.FFConfig()
    for name in ("learning_rate", "perform_fusion"):
        assert getattr(cfg, name) == getattr(jcfg, name)


# -- initializers -------------------------------------------------------------

@pytest.mark.parametrize("name", ["zeros", "ones", "uniform", "normal",
                                  "norm", "zero", "one", "glorot_uniform"])
def test_initializer_aliases_are_jax_aliases(name):
    assert (type(tinit.get_initializer(name)).__name__
            == type(jinit.get_initializer(name)).__name__)


def _draw(init_t, init_j, shape=(N,)):
    gen = torch.Generator().manual_seed(0)
    t = init_t(gen, shape, torch.float32).numpy().ravel()
    j = np.asarray(init_j(jax.random.PRNGKey(0), shape, jnp.float32)).ravel()
    return t, j


_CASES = {
    "uniform": (lambda m: m.UniformInitializer(), 0.5, 1 / 12),
    "uniform_range": (lambda m: m.UniformInitializer(0, -2.0, 3.0), 0.5,
                      25 / 12),
    "normal": (lambda m: m.NormInitializer(), 0.0, 1.0),
    "normal_shifted": (lambda m: m.NormInitializer(0, 1.5, 2.0), 1.5, 4.0),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_initializers_match_jax_in_distribution(case):
    make, mean, var = _CASES[case]
    t, j = _draw(make(tinit), make(jinit))
    assert abs(t.mean() - mean) < 5 * np.sqrt(var / N)
    assert abs(t.var() / var - 1) < 0.02
    assert stats.ks_2samp(t, j).pvalue > 1e-4
    if case.startswith("uniform"):
        lo, hi = (-2.0, 3.0) if case == "uniform_range" else (0.0, 1.0)
        assert t.min() >= lo and t.max() < hi


def test_initializers_draw_from_the_generator_given():
    for init in (tinit.UniformInitializer(), tinit.NormInitializer()):
        a = init(torch.Generator().manual_seed(3), (4, 5), torch.bfloat16)
        b = init(torch.Generator().manual_seed(3), (4, 5), torch.bfloat16)
        c = init(torch.Generator().manual_seed(4), (4, 5), torch.bfloat16)
        assert a.dtype == torch.bfloat16 and a.shape == (4, 5)
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_a_dense_layer_takes_a_named_initializer():
    m = FFModel(FFConfig(batch_size=2, device="cpu"))
    t = m.dense(m.create_tensor((2, 64)), 256, kernel_initializer="normal",
                bias_initializer="ones")
    m.compile(loss_type=LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    (ws,) = m.params.values()
    assert torch.equal(ws["bias"], torch.ones(256))
    k = ws["kernel"].numpy().ravel()
    assert abs(k.mean()) < 5 / np.sqrt(k.size) and abs(k.std() - 1) < 0.02
    assert t.dims == (2, 256)
