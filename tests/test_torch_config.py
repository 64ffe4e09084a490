"""The port's config layer against the JAX package's, on the CPU.

- ``yaml_subset.load`` against ``yaml.safe_load`` on every file of the config
  tree, on a corpus of command-line values and on generated scalars and text,
  compared type-strictly (``True`` is not ``1``, ``1.0`` is not ``1``); what
  lies outside the subset raises with its file and line;
- ``yaml_subset.dump`` read back by ``yaml.safe_load``, and ``print_config``'s
  text read back equal to the composed tree;
- the port's ``compose`` against the JAX ``compose`` on both roots, every
  experiment, debug bundle, hparams_search bundle, trainer and logger choice,
  ``+key=`` and ``~key=``, ``${oc.env:...}`` with and without its variable,
  the CLI precedence of tests/test_configs.py, and the errors;
- ``extras.enforce_tags``.
"""

from __future__ import annotations

import json
import math
import string
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from anomalyclip_tpu.config import compose as jax_compose
from anomalyclip_tpu.config import to_dict as jax_to_dict
from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict, yaml_subset
from anomalyclip_tpu_torch.utils import extras

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "anomalyclip_tpu" / "configs"
FILES = sorted(CONFIG_DIR.rglob("*.yaml"))
EXPERIMENTS = ("ucfcrime", "shanghaitech", "xdviolence", "synthetic")


def same(a, b) -> bool:
    """Equal in value, type and key order, nan equal to nan."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return len(a) == len(b) and all(
            same(ka, kb) and same(va, vb) for (ka, va), (kb, vb) in zip(a.items(), b.items())
        )
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def same_unordered(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_unordered(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same_unordered(x, y) for x, y in zip(a, b))
    return same(a, b)


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


def test_the_config_tree_has_47_files():
    assert len(FILES) == 47
    assert default_config_dir() == CONFIG_DIR


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(CONFIG_DIR)) for p in FILES])
def test_every_config_file_reads_as_safe_load(path):
    text = path.read_text()
    got = yaml_subset.load(text, str(path))
    assert same(got, yaml.safe_load(text))
    assert same(yaml.safe_load(yaml_subset.dump(got)), got) if got is not None else True


CLI_VALUES = [
    "1.e-6", "5.e-4", "1.", "1e-5", "1.0e+5", "3.4e-05", "-2.5", ".5", "+.inf", "-.inf", ".nan", ".NaN",
    "0", "7", "-3", "+12", "0x10", "-0x10", "010", "0b101", "1_000", "1:30", "08",
    "True", "False", "true", "FALSE", "yes", "No", "on", "Off", "y", "null", "Null", "~", "None", "none",
    "???", '""', "''", '"{:06d}.jpg"', "'it''s'", '"a\\tb\\x41\\u00e9"', "ViT-B/16", "ViT-L/14@336px",
    "${oc.env:UCFCRIME_ROOT,/usr/src/datasets/UCFCrime}/Image-Features/", "${paths.output_dir}/checkpoints",
    "auto", "cpu", "/tmp/run dir/last", "a:b", ":a", "-x", "a#b", "a  # a comment",
    '["dev"]', "[2, 3, 5]", "[a,b]", "[]", "[[1, 2], [3]]", "[a, ]", "{}", "[1.e-4, 0x1f, yes, ~, 'q']",
    "experiment_1", "anomaly_clip_ucfcrime", "epoch_{epoch:03d}", "- a", "a: b",
]


@pytest.mark.parametrize("value", CLI_VALUES)
def test_cli_values_read_as_safe_load(value):
    assert same(yaml_subset.load(value), yaml.safe_load(value)), (value, yaml_subset.load(value))


_PLAIN_ALPHABET = string.ascii_letters + string.digits + "_./$:{}-,@=~+"


def _plain_ok(text: str) -> bool:
    return text[0] not in "-:,{}@~" and not text.endswith(":") and "#" not in text


def _scalars(plain_alphabet: str):
    return st.one_of(
        st.integers().map(str),
        st.integers().map(lambda n: f"{'-' if n < 0 else ''}0x{abs(n):x}"),
        st.integers(min_value=0).map(lambda n: f"0{n:o}"),
        st.floats(allow_nan=False).map(repr),
        st.floats(allow_nan=False, allow_infinity=False).map(lambda f: f"{f:.3e}"),
        st.tuples(st.integers(0, 99), st.integers(0, 12), st.sampled_from("+-")).map(
            lambda t: f"{t[0]}.e{t[2]}{t[1]}"),
        st.sampled_from(["yes", "No", "ON", "off", "True", "false", "null", "~", "NULL", ".inf", "-.Inf", ".nan"]),
        st.text(plain_alphabet, min_size=1, max_size=24).filter(_plain_ok),
        st.text(st.characters(codec="utf-8", exclude_categories=("Cs", "Cc")), max_size=16).map(json.dumps),
        st.text(string.printable.replace("\t", "").replace("\n", "").replace("\r", "").replace("\x0b", "")
                .replace("\x0c", ""), max_size=16).map(lambda s: "'" + s.replace("'", "''") + "'"),
    )


# a flow sequence's plain scalars end at its indicators
_FLOW_LISTS = st.lists(_scalars(_PLAIN_ALPHABET.replace("{", "").replace("}", "").replace(",", "")),
                       max_size=4).map(lambda v: "[" + ", ".join(v) + "]")


@settings(max_examples=300, derandomize=True, deadline=None, suppress_health_check=list(HealthCheck))
@given(value=st.one_of(_scalars(_PLAIN_ALPHABET), _FLOW_LISTS))
def test_admitted_scalars_read_as_safe_load(value):
    assert same(yaml_subset.load(value), yaml.safe_load(value)), value


_TEXT = st.text(string.ascii_letters[:6] + string.digits[:4] + " -:#[]{},'\"&*!|>?~.$/\n", max_size=30)


@settings(max_examples=400, derandomize=True, deadline=None, suppress_health_check=list(HealthCheck))
@given(text=_TEXT)
def test_any_text_is_read_as_safe_load_or_refused(text):
    """Whatever the reader takes, it reads as PyYAML does; it never takes what
    PyYAML refuses."""
    try:
        got = yaml_subset.load(text)
    except yaml_subset.YAMLSubsetError:
        return
    assert same(got, yaml.safe_load(text)), text


_TREES = st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(), st.floats(), st.text(max_size=8),
              st.sampled_from(["1e-5", "yes", "", " x", "a: b", "- a", "#", "${a.b}", "[a]", "010"])),
    lambda children: st.one_of(st.lists(children, max_size=3),
                               st.dictionaries(st.one_of(st.text(max_size=6), st.integers()), children,
                                               max_size=3)),
    max_leaves=12,
)


@settings(max_examples=200, derandomize=True, deadline=None, suppress_health_check=list(HealthCheck))
@given(tree=_TREES)
def test_dump_reads_back(tree):
    text = yaml_subset.dump(tree)
    assert same(yaml.safe_load(text), tree), text
    assert same(yaml_subset.load(text), tree), text


@pytest.mark.parametrize("text, line, what", [
    ("a: 1\nb: &x 2\n", 2, "anchor"),
    ("a: 1\nb: *x\n", 2, "alias"),
    ("a: !!str 1\n", 1, "tag"),
    ("# head\na: |\n  text\n", 2, "block scalar"),
    ("a: >\n  folded\n", 1, "block scalar"),
    ("a: {b: 1}\n", 1, "flow mapping"),
    ("? a\n: 1\n", 1, "complex key"),
    ("a: [1,\n  2]\n", 1, "does not close"),
    ("---\na: 1\n", 1, "document marker"),
    ("a: 2024-01-01\n", 1, "timestamp"),
    ("<<: 1\n", 1, "merge"),
    ("a: one\n  two\n", 2, "continued"),
    ("a:\n\tb: 1\n", 2, "tab"),
    ("%YAML 1.1\na: 1\n", 1, "directive"),
])
def test_outside_the_subset_raises_with_file_and_line(text, line, what):
    with pytest.raises(yaml_subset.YAMLSubsetError, match=f"^cfg.yaml:{line}: .*{what}"):
        yaml_subset.load(text, "cfg.yaml")


def test_wrong_yaml_raises_as_safe_load_does():
    for text in ("a: b: c", "[a, b", "a: [1]x", "a:\n  b: 1\n c: 2", "- a\nb: 1"):
        with pytest.raises(yaml.YAMLError):
            yaml.safe_load(text)
        with pytest.raises(yaml_subset.YAMLSubsetError):
            yaml_subset.load(text)


# ---------------------------------------------------------------------------
# compose
# ---------------------------------------------------------------------------


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("PROJECT_ROOT", str(ROOT))
    for var in ("UCFCRIME_ROOT", "SHANGHAITECH_ROOT", "XDVIOLENCE_ROOT", "SYNTHETIC_ROOT", "LOG_DIR",
                "ANOMALYCLIP_CONFIG_DIR"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _both(root: str, overrides, resolve: bool = True):
    got = to_dict(compose(CONFIG_DIR, root, list(overrides), resolve=resolve))
    want = jax_to_dict(jax_compose(CONFIG_DIR, root, list(overrides), resolve=resolve))
    return got, want


def _hs_cases():
    names = sorted(p.stem for p in (CONFIG_DIR / "hparams_search").glob("*.yaml"))
    return [["experiment=" + n.rsplit("_", 1)[0], f"hparams_search={n}"] for n in names]


COMPOSE_CASES = (
    [("train", [f"experiment={e}"]) for e in EXPERIMENTS]
    + [("eval", [f"experiment={e}"]) for e in EXPERIMENTS]
    + [("eval", ["data=ucfcrime", "model=anomaly_clip_ucfcrime", "ckpt_path=/tmp/ck"]),
       ("eval", ["data=synthetic", "model=anomaly_clip_synthetic", "ckpt_path=run/checkpoints/last",
                 "trainer=cpu"])]
    + [("train", ["experiment=synthetic", f"debug={d}"])
       for d in sorted(p.stem for p in (CONFIG_DIR / "debug").glob("*.yaml"))]
    + [("train", case) for case in _hs_cases()]
    + [("train", ["experiment=synthetic", f"trainer={t}"])
       for t in sorted(p.stem for p in (CONFIG_DIR / "trainer").glob("*.yaml"))]
    + [("train", ["experiment=ucfcrime", f"logger={g}"])
       for g in sorted(p.stem for p in (CONFIG_DIR / "logger").glob("*.yaml"))]
    + [("train", ["experiment=ucfcrime", "model.net.emb_size=64", "trainer.max_epochs=7", "seed=3"]),
       ("train", ["experiment=synthetic", "+model.net.extra=1.e-3", "+newkey=[a, 2]", "~trainer.profiler=null"]),
       ("train", ["experiment=synthetic", "logger=null", "callbacks=early_stopping", "tags=[x,y]"]),
       ("train", ["experiment=ucfcrime", "trainer=cpu", "data.load_from_features=False", "model.solver.lr=1e-5",
                  "model.net.clip_ckpt_path=/w/ViT-B-16.pt", "paths.log_dir=/tmp/l", "exp_name=ucfcrime/0"]),
       ("train", ["data=shanghaitech", "model=anomaly_clip_shanghaitech"]),
       ("train", [])]
)


@pytest.mark.parametrize("root, overrides", COMPOSE_CASES, ids=[f"{r}:{' '.join(o)}" for r, o in COMPOSE_CASES])
def test_compose_equals_the_jax_compose(env, root, overrides):
    got, want = _both(root, overrides)
    assert same(got, want)


@pytest.mark.parametrize("with_var", [False, True])
def test_oc_env_with_and_without_the_variable(env, tmp_path, with_var):
    if with_var:
        env.setenv("UCFCRIME_ROOT", str(tmp_path))
        env.setenv("LOG_DIR", str(tmp_path / "logs"))
    got, want = _both("train", ["experiment=ucfcrime"])
    assert same(got, want)
    root = str(tmp_path) if with_var else "/usr/src/datasets/UCFCrime"
    assert got["data"]["frames_root"] == f"{root}/Image-Features/"
    assert got["data"]["annotation_file_test"] == f"{root}/Annotations/Anomaly_Test.txt"
    assert got["paths"]["log_dir"] == (str(tmp_path / "logs") if with_var else f"{ROOT}/logs")


def test_unresolved_compose_and_precedence(env):
    got, want = _both("train", ["experiment=ucfcrime", "seed=5"], resolve=False)
    assert same(got, want)
    assert got["data"]["frames_root"].startswith("${oc.env:UCFCRIME_ROOT")
    cfg = compose(CONFIG_DIR, "train", ["experiment=ucfcrime", "model.net.emb_size=64", "trainer.max_epochs=7",
                                        "seed=3"])
    assert (cfg.model.net.emb_size, cfg.trainer.max_epochs, cfg.seed) == (64, 7, 3)
    # the CLI's group choice wins over the experiment's
    cfg = compose(CONFIG_DIR, "train", ["experiment=ucfcrime", "trainer=cpu"])
    assert cfg.trainer.accelerator == "cpu"
    assert compose(CONFIG_DIR, "train", ["experiment=ucfcrime"]).trainer.accelerator == "tpu"
    assert type(cfg.model.loss.lambda_smooth) is float and cfg.model.solver.lr == 1e-5


def test_compose_errors_match(env):
    for overrides, error in ((["experiment=nope"], FileNotFoundError), (["~seed"], ValueError),
                             (["experiment=synthetic", "paths.output_dir=${no.such.key}"], KeyError)):
        with pytest.raises(error):
            jax_compose(CONFIG_DIR, "train", overrides)
        with pytest.raises(error):
            compose(CONFIG_DIR, "train", overrides)


def test_config_dir_override(env, tmp_path):
    env.setenv("ANOMALYCLIP_CONFIG_DIR", str(tmp_path))
    assert default_config_dir() == tmp_path


# ---------------------------------------------------------------------------
# extras
# ---------------------------------------------------------------------------


def test_print_config_reads_back_as_the_composed_tree(env):
    cfg = compose(CONFIG_DIR, "train", ["experiment=ucfcrime", "tags=[a, 'b c']"])
    text = extras.config_text(cfg)
    head, body = text.split("\n", 1)
    assert head == "config tree:"
    assert same_unordered(yaml.safe_load(body), to_dict(cfg))
    assert list(yaml.safe_load(body))[:7] == ["data", "model", "callbacks", "logger", "trainer", "paths", "extras"]
    logged = []
    env.setattr(extras.log, "info", logged.append)
    extras.apply_extras(cfg)
    assert logged == [text]


def test_enforce_tags_refuses_untagged_runs(env):
    for tags in ("[dev]", "[]"):
        cfg = compose(CONFIG_DIR, "train", ["experiment=synthetic", "extras.enforce_tags=True",
                                            "extras.print_config=False", f"tags={tags}"])
        with pytest.raises(SystemExit, match="enforce_tags"):
            extras.apply_extras(cfg)
    cfg = compose(CONFIG_DIR, "train", ["experiment=synthetic", "extras.enforce_tags=True",
                                        "extras.print_config=False", "tags=[ucf_run]",
                                        "extras.compilation_cache=True"])
    extras.apply_extras(cfg)  # compilation_cache is read by nothing
