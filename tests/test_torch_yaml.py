"""The port's YAML loader against ``mlvae_tpu.hyperyaml`` on the cases of
``tests/test_hyperyaml.py`` (``!ref`` with arithmetic and interpolation,
``!new``, ``!name``, ``!apply``, ``!copy``, ``!include`` with child
overrides, ``!PLACEHOLDER``, tuples, overrides and the ``extra_overrides``
channel): the resolved values must be equal. Then its registry (every
alias of the JAX registry resolves to a port target or raises
``NotImplementedError``), the device and generator it hands to the port's
modules, the byte-identical copy of the MD_VAE recipe, and
``config/run.yaml`` with that recipe: a port ``SBModel`` whose parameters
are ``convert.from_jax`` of the JAX ``SBModel``'s by name and shape, and
whose TEST forward on one batch, from the JAX weights with the draws
replayed, gives the JAX eval step's losses within rel 1e-4 and its decode
bit-exact."""
import collections
import fractions
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mlvae_tpu.bench_utils import synth_batch as jax_synth_batch
from mlvae_tpu.hyperyaml import load_hyperyaml as jax_load
from mlvae_tpu.hyperyaml import recursive_update as jax_recursive_update
from mlvae_tpu.hyperyaml import registry as jax_registry
from mlvae_tpu.hyperyaml.loader import _parse_tagged as jax_parse_tagged
from mlvae_tpu.models.MD_VAE.model import SBModel as JaxSBModel
from mlvae_tpu.training.brain import Stage as JaxStage

from mlvae_tpu_torch.bench_utils import synth_batch
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.hyperyaml import load_hyperyaml, recursive_update
from mlvae_tpu_torch.hyperyaml import registry
from mlvae_tpu_torch.hyperyaml.loader import _parse_tagged
from mlvae_tpu_torch.models.MD_VAE.model import SBModel, Target
from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.training.brain import Stage
from test_torch_train_step import DECODED, _replay

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "mlvae_tpu_torch/models/MD_VAE/model.yaml"
JAX_RECIPE = REPO / "mlvae_tpu/models/MD_VAE/model.yaml"
RTOL = 1e-4
B, T, L = 4, 24, 4
NARROW = ("{model: {phn_rnn_hidden_size: 32, boundary_rnn_hidden_size: 32, "
          "rnn_hidden_size: 32, dec_rnn_hidden_size: 32}}")

CASES = {
    "ref_and_arithmetic": ("a: 3\nb: !ref <a>\nc: !ref <a> * 2 + 1\n"
                           "d: !ref <a> // 2\ne: results/<nothing\n", {}),
    "interpolation": ("name: exp1\nout: !ref results/<name>/ckpt\n", {}),
    "chained_refs": ("a: 3.5\nb: !ref <a>\nc: !ref <b>\n", {}),
    "new": ("a: 3\nthing: !new:collections.Counter\n    b: !ref <a>\n", {}),
    "shared_ref": ("enc: !new:collections.Counter\n    x: 1\n"
                   "modules:\n    enc: !ref <enc>\n"
                   "recoverables:\n    enc: !ref <enc>\n", {}),
    "copy": ("enc: !new:collections.Counter\n    x: 1\n"
             "other: !copy <enc>\n", {}),
    "placeholder_overridden": ("a: !PLACEHOLDER", {"overrides": {"a": 5}}),
    "tuple": ("a: (3, 4)\nb: !tuple (1, 2, 3)\n"
              "pattern: \"(.*)\"\n", {}),
    "name": ("fn: !name:builtins.round\n    ndigits: 2\n", {}),
    "attribute_ref": ("thing: !new:fractions.Fraction\n    numerator: 3\n"
                      "    denominator: 4\nnum: !ref <thing.numerator>\n", {}),
    "overrides_affect_refs": ("a: 3\nb: !ref <a> * 2\n",
                              {"overrides": {"a": 5}}),
    "extra_overrides": ("a: 3\nb: !ref <a>*2\n",
                        {"extra_overrides": {"a": 5}}),
    "extra_overrides_tag": ("a: 3\nb: 1\n",
                            {"extra_overrides": "b: !ref <a>"}),
    "override_list": ("a: 1\nb: !ref <a>\n",
                      {"overrides": ["a: 2", {"a": 4}]}),
    "apply_sum": ("__x: !apply:builtins.sum [[1, 2]]\n"
                  "y: !apply:builtins.max [3, 9]\n", {}),
    "module": ("m: !module:os.path\n", {}),
}


def _plain(x):
    """A loaded tree with objects replaced by what identifies them."""
    if isinstance(x, dict) and type(x) is dict:
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, functools.partial):
        return ("partial", x.func.__name__,
                {k: _plain(v) for k, v in x.keywords.items()
                 if k not in ("device", "generator")})
    if isinstance(x, (int, float, str, bool, type(None))):
        return x
    if isinstance(x, (collections.Counter, fractions.Fraction)):
        return x
    return ("object", type(x).__name__)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_jax(case):
    text, kw = CASES[case]
    got, want = load_hyperyaml(text, **kw), jax_load(text, **kw)
    assert _plain(got) == _plain(want)
    assert "__x" not in got


def test_shared_refs_and_copies_are_objects_as_in_jax():
    h = load_hyperyaml(CASES["shared_ref"][0])
    assert h["modules"]["enc"] is h["enc"] is h["recoverables"]["enc"]
    h = load_hyperyaml(CASES["copy"][0])
    assert h["other"] == h["enc"] and h["other"] is not h["enc"]


@pytest.mark.parametrize("text,match", [
    ("a: !PLACEHOLDER", "PLACEHOLDER"),
    ("a: !ref <a>/x\n", "Circular"),
    ("m: !module:os.path {a: 1}\n", "Cannot pass args"),
])
def test_loader_refuses_as_jax(text, match):
    for load in (load_hyperyaml, jax_load):
        with pytest.raises(ValueError, match=match):
            load(text)


def test_include_with_child_overrides(tmp_path):
    inc = tmp_path / "model.yaml"
    inc.write_text("size: !PLACEHOLDER\ndouble: !ref <size> * 2\n")
    main = tmp_path / "run.yaml"
    main.write_text("n: 8\nmodel: !PLACEHOLDER\n    size: !ref <n>\n")
    out = []
    for load, parse in ((load_hyperyaml, _parse_tagged),
                        (jax_load, jax_parse_tagged)):
        with open(main) as f:
            out.append(load(f, overrides=parse("model: !include:model.yaml")))
    assert out[0] == out[1] == {"n": 8, "model": {"size": 8, "double": 16}}


def test_recursive_update_keep_objects_as_jax():
    obj = object()
    got = {"model": {"checkpointer": obj, "n_epochs": 5}, "b": {"c": 2}}
    want = {"model": {"checkpointer": obj, "n_epochs": 5}, "b": {"c": 2}}
    upd = {"model": {"checkpointer": {"backend": "npz"}, "n_epochs": 2},
           "b": {"d": 3}}
    recursive_update(got, upd, keep_objects=True)
    jax_recursive_update(want, upd, keep_objects=True)
    assert got == want and got["model"]["checkpointer"] is obj


@pytest.mark.parametrize("name", sorted(jax_registry._ALIASES))
def test_every_jax_alias_has_a_port_target_or_names_its_item(name):
    try:
        target = registry.locate(name)
    except NotImplementedError as e:
        assert "ROADMAP queue 1 item" in str(e), e
        return
    assert target is not None, name
    assert getattr(target, "__module__", "").startswith(
        ("mlvae_tpu_torch", "builtins")), (name, target)


@pytest.mark.parametrize("name", [
    "modules.fc_block.FCBlock", "utils.phonemes.PhonemeSetHandler",
    "models.MD_VAE.model.SBModel", "datasets.SynAudioMNIST.prepare.prepare"])
def test_prefix_remaps_resolve_into_the_port(name):
    target = registry.locate(name)
    assert target.__module__.startswith("mlvae_tpu_torch."), target


@pytest.mark.parametrize("name,match", [
    ("mlvae_tpu.modules.hmm_aligner.HMMAligner", "no alias"),
    ("modules.wav2vec2.Wav2Vec2Encoder", "item 11"),
    ("speechbrain.lobes.models.huggingface_wav2vec.HuggingFaceWav2Vec2",
     "item 11"),
    ("torch.nn.Linear", "no alias"),
    ("speechbrain.nnet.CNN.Conv1d", "no alias"),
    ("mlvae_tpu.nn.rnn.LSTM", "no alias"),
])
def test_no_plain_import_of_library_or_jax_names(name, match):
    if match == "item 11":
        # the wav2vec2 names, refused until item 11 ported the encoder,
        # resolve into the port
        assert registry.locate(name).__module__ == \
            "mlvae_tpu_torch.modules.wav2vec2"
        return
    with pytest.raises(NotImplementedError, match=match):
        registry.locate(name)


def test_public_surface_names_the_jax_packages():
    import mlvae_tpu.hyperyaml as jax_hyperyaml
    import mlvae_tpu_torch.hyperyaml as port_hyperyaml
    assert set(jax_hyperyaml.__all__) <= set(port_hyperyaml.__all__)
    assert "register" in port_hyperyaml.__all__
    for name in port_hyperyaml.__all__:
        assert getattr(port_hyperyaml, name).__module__.startswith(
            "mlvae_tpu_torch."), name


def test_register_as_jax(monkeypatch):
    """``register`` as the JAX registry's: an object or a dotted path
    under a YAML-visible name, which wins over every alias; a path into
    the JAX package or JAX is refused."""
    from mlvae_tpu_torch.hyperyaml import register
    from mlvae_tpu.hyperyaml.registry import register as jax_register
    monkeypatch.setattr(registry, "_EXTRA", {})
    monkeypatch.setattr(jax_registry, "_EXTRA", {})
    calls = []
    for reg in (register, jax_register):
        reg("testing.record", lambda v: calls.append(v) or v)
        reg("testing.counter", "collections.Counter")
    text = ("__x: !apply:testing.record [42]\ny: 1\n"
            "c: !new:testing.counter\n    a: 2\n")
    got, want = load_hyperyaml(text, device="cpu"), jax_load(text)
    assert calls == [42, 42]
    assert got == want == {"y": 1, "c": collections.Counter(a=2)}
    register("torch.nn.LSTM", FCBlock)   # a registration wins
    assert registry.locate("torch.nn.LSTM") is FCBlock
    for target in ("mlvae_tpu.nn.rnn.LSTM", "jax.numpy.add"):
        with pytest.raises(ValueError, match="never resolves"):
            register("testing.bad", target)


def test_jax_name_of_the_augmenter_resolves_to_the_port():
    from mlvae_tpu_torch.ops.augment import WaveAugment
    assert registry.locate("mlvae_tpu.ops.augment.WaveAugment") \
        is WaveAugment
    text = ("aug: !new:mlvae_tpu.ops.augment.WaveAugment\n"
            "    speeds: [0.9, 1.1]\n    noise_snr_db: 20\n")
    aug, jax_aug = load_hyperyaml(text, device="cpu")["aug"], \
        jax_load(text)["aug"]
    assert isinstance(aug, WaveAugment)
    assert type(jax_aug).__module__ == "mlvae_tpu.ops.augment"
    assert (aug.speeds, aug.noise_snr_db) == (jax_aug.speeds,
                                              jax_aug.noise_snr_db)


def _dump_trees(ph, ref):
    return {
        "flat": {"a": ph(), "b": ref("<a>")},
        "nested": {"model": {"size": ph(), "double": ref("<size> * 2"),
                             "layers": [1, ref("<model[size]>"), None]},
                   "name": "x", "rate": 0.5, "on": True},
        "list": [ph(), {"k": [ref("<a>/<b>"), "s"]}, 3],
    }


@pytest.mark.parametrize("tree", ["flat", "nested", "list"])
def test_dump_hyperyaml_bytes_equal_to_jax(tree):
    from io import StringIO
    from mlvae_tpu.hyperyaml import Placeholder as JaxPlaceholder
    from mlvae_tpu.hyperyaml import RefTag as JaxRefTag
    from mlvae_tpu.hyperyaml import dump_hyperyaml as jax_dump
    from mlvae_tpu_torch.hyperyaml import (Placeholder, RefTag,
                                           dump_hyperyaml)
    got, want = StringIO(), StringIO()
    dump_hyperyaml(_dump_trees(Placeholder, RefTag)[tree], got)
    jax_dump(_dump_trees(JaxPlaceholder, JaxRefTag)[tree], want)
    assert got.getvalue().encode() == want.getvalue().encode()
    assert "!PLACEHOLDER" in got.getvalue() and "!ref" in got.getvalue()
    # the dump parses back to the tagged tree it came from
    parsed = _parse_tagged(got.getvalue())
    first = parsed[0] if tree == "list" else parsed.get("a", None)
    if first is not None:
        assert first.tag == "!PLACEHOLDER"


def test_recipe_copy_is_byte_identical():
    assert RECIPE.read_bytes() == JAX_RECIPE.read_bytes()


FC_YAML = ("seed: 7\n__set_seed: !apply:torch.manual_seed [!ref <seed>]\n"
           "fc: !new:modules.fc_block.FCBlock\n    fc_sizes: [6, 5, 4]\n")


def test_modules_get_the_runs_device_and_generator(monkeypatch):
    """The loader builds port modules on its device, with weights drawn
    from its generator as the YAML's manual_seed seeded it: the same seed
    gives the same weights; a generator passed in is the one seeded.
    ``device=None`` means CUDA and raises without a card."""
    one = load_hyperyaml(FC_YAML, device="cpu")["fc"]
    two = load_hyperyaml(FC_YAML, device="cpu")["fc"]
    assert isinstance(one, FCBlock)
    for a, b in zip(one.parameters(), two.parameters()):
        assert a.device.type == "cpu" and torch.equal(a, b)
    gen = torch.Generator()
    load_hyperyaml(FC_YAML, device="cpu", generator=gen)
    assert gen.initial_seed() == 7
    other = load_hyperyaml(FC_YAML.replace("seed: 7", "seed: 8"),
                           device="cpu")["fc"]
    assert not torch.equal(next(one.parameters()),
                           next(other.parameters()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_hyperyaml(FC_YAML)
    assert load_hyperyaml("a: 1\nb: !ref <a> + 2") == {"a": 1, "b": 3}


def _run_yaml(jax_side: bool):
    load, parse = (jax_load, jax_parse_tagged) if jax_side else \
        (load_hyperyaml, _parse_tagged)
    recipe = JAX_RECIPE if jax_side else RECIPE
    overrides = parse(
        "dataset: SynAudioMNIST\nlanguage: digits\nn_phonemes: 12\n"
        "model_class: MD_VAE\nmodel_name: yaml\n"
        f"model: !include:{recipe}\n")
    kw = {} if jax_side else {"device": "cpu"}
    with open(REPO / "config/run.yaml") as f:
        return load(f, [parse(NARROW), overrides], **kw)


@pytest.fixture(scope="module")
def built():
    jh, ph = _run_yaml(True), _run_yaml(False)
    jm = JaxSBModel(modules=jh["model"]["modules"], hparams=jh["model"],
                    run_opts={}, checkpointer=None, label_encoder=None)
    jm.init_params()
    jm.ensure_states(jh["model"]["input_size"])
    rs = np.random.RandomState(3)
    C = jh["model"]["input_size"]
    jm.states["normalizer"] = {
        "count": np.float32(12.0),
        "glob_mean": rs.randn(C).astype(np.float32) * 0.2,
        "glob_std": (0.5 + rs.rand(C)).astype(np.float32)}
    pm = SBModel(modules=ph["model"]["modules"], hparams=ph["model"],
                 run_opts={}, device="cpu")
    return jh, ph, jm, pm


def test_run_yaml_resolves_as_jax(built):
    jh, ph, _, _ = built
    assert _plain(ph) == _plain(jh)
    assert ph["model"]["input_size"] == 120
    assert ph["model"]["rnn_hidden_size"] == 32


def test_recipe_builds_the_jax_models_parameters(built):
    _, ph, jm, pm = built
    want = from_jax(jax.device_get(jm.params), jax.device_get(jm.states))
    got = pm.state_dict()
    assert list(sorted(got)) == list(sorted(want))
    for key, value in want.items():
        assert tuple(got[key].shape) == tuple(value.shape), key
        assert got[key].device.type == "cpu"
    assert pm.normalizer is ph["model"]["normalizer"]
    assert pm.rnn is ph["model"]["modules"]["rnn"]
    assert pm.checkpointer is None and pm.target == Target.TEST


def test_recipe_test_forward_matches_jax(built):
    _, _, jm, pm = built
    pm.load_state_dict(from_jax(jax.device_get(jm.params),
                                jax.device_get(jm.states)))
    jbatch = jax_synth_batch(B, T, L, seed=4)
    batch = synth_batch(B, T, L, seed=4, device="cpu")
    batch["id"] = [f"u{i}" for i in range(B)]
    rng = jax.random.PRNGKey(11)
    jm.on_stage_start(JaxStage.TEST, 3)
    step = jm._get_compiled("eval", JaxStage.TEST)
    j_preds, j_loss, j_losses = step(jm.params, jm.states, rng, jbatch,
                                     np.int32(3))
    pm.on_stage_start(Stage.TEST, 3)
    preds, loss, losses = pm.eval_forward(
        pm.prepare_batch(batch), 3,
        noise=_replay(pm.draws(B, T, train=False), rng))
    for key in DECODED[:1] + DECODED[2:]:
        np.testing.assert_array_equal(preds[key].numpy(),
                                      np.asarray(j_preds[key]), err_msg=key)
    assert set(losses) == set(j_losses)
    for key in j_losses:
        np.testing.assert_allclose(float(losses[key]), float(j_losses[key]),
                                   rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
