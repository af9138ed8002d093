"""The configuration tree as plain dataclass records (utils.records): every
shipped `.hparams.json` parses and dumps back to the same JSON, byte for
byte with the CLI's formatting, and malformed configs are refused."""

import copy
import dataclasses
import json
import pathlib

import pytest

from autognothi.pipeline.config import ExpConfig
from autognothi.utils.records import Record, project

REPO = pathlib.Path(__file__).resolve().parents[1]
SHIPPED = sorted(REPO.glob("experiments/*/.hparams.json"))


def test_every_shipped_experiment_is_covered():
    assert len(SHIPPED) == 14


@pytest.mark.parametrize("path", SHIPPED, ids=[p.parent.name for p in SHIPPED])
def test_shipped_hparams_round_trip(path):
    text = path.read_text("utf-8")
    raw = json.loads(text)
    cfg = ExpConfig.from_dict(raw)
    assert cfg.schema_version == raw["$schema"]
    dumped = cfg.to_dict(exclude_unset=True)
    assert dumped == raw
    assert list(dumped) == list(raw)  # field names and order unchanged
    assert json.dumps(dumped, indent=2) + "\n" == text
    # the full dump (loggers' flatten_dump) adds the unset defaults
    full = cfg.to_dict()
    assert set(full) >= set(raw) and "$schema" in full


def _raw():
    path = REPO / "experiments" / "vit_base_imagenette_vanilla"
    return json.loads((path / ".hparams.json").read_text("utf-8"))


@pytest.mark.parametrize("section", ["dataset", "net"])
def test_unknown_kind_is_refused(section):
    raw = _raw()
    raw[section]["kind"] = "no_such_kind"
    with pytest.raises(ValueError, match="unknown kind 'no_such_kind'"):
        ExpConfig.from_dict(raw)


def test_missing_field_is_refused():
    raw = _raw()
    del raw["net"]["params"]["hidden_size"]
    with pytest.raises(ValueError, match="missing field 'hidden_size'"):
        ExpConfig.from_dict(raw)
    raw = _raw()
    del raw["seed"]
    with pytest.raises(ValueError, match="missing field 'seed'"):
        ExpConfig.from_dict(raw)


@pytest.mark.parametrize("where,value,message", [
    (("net", "base_model"), "gg_bert_base", "is not one of"),
    (("seed",), "42", "expected an int"),
    (("net", "params", "explainer_normalize"), 1, "expected a bool"),
    (("train_classifier", "lr"), "fast", "expected a number"),
])
def test_wrong_types_are_refused(where, value, message):
    raw = _raw()
    node = raw
    for key in where[:-1]:
        node = node[key]
    node[where[-1]] = value
    with pytest.raises(ValueError, match=message):
        ExpConfig.from_dict(raw)


def test_ints_widen_to_float_fields():
    raw = _raw()
    raw["train_classifier"]["lr"] = 1
    cfg = ExpConfig.from_dict(raw)
    assert cfg.train_classifier.lr == 1.0
    assert isinstance(cfg.train_classifier.lr, float)


def test_assigned_fields_are_dumped():
    """A field set after parsing (the wandb run id the env persists) is
    written back even though the input left it out."""
    raw = _raw()
    raw["logger_explainer"] = {"wandb_enabled": False, "wandb_project": "p",
                               "wandb_name": "n"}
    cfg = ExpConfig.from_dict(copy.deepcopy(raw))
    assert "wandb_run_id" not in cfg.to_dict(exclude_unset=True)[
        "logger_explainer"]
    cfg.logger_explainer.wandb_run_id = "abc"
    assert cfg.to_dict(exclude_unset=True)["logger_explainer"][
        "wandb_run_id"] == "abc"


def test_project_views_a_variant_as_its_base():
    @dataclasses.dataclass(kw_only=True)
    class Base(Record):
        a: int

    @dataclasses.dataclass(kw_only=True)
    class Variant(Base):
        b: str

    assert project(Variant(a=1, b="x"), Base) == Base(a=1)
