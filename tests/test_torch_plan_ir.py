"""The port's step-plan IR (``tpu_dist_torch/plan/ir.py``) against the
reference's (``tpu_dist/plan/ir.py``): a plan file is interchangeable
between the two packages.

* the same plan has the same canonical JSON bytes and ``plan_hash`` in
  both, over the reference's whole ``default_space`` (both engines, 1 and
  8 devices);
* validation refuses the same illegal combinations with the same
  ``PlanError`` messages (``tests/test_plan.py:70-104``), and the mesh
  check agrees;
* ``load_plan_file`` / ``plan_for_device`` read each other's files,
  ``apply_plan_to_config`` rewrites the same fields of both packages'
  configs, ``plan_knob_summary`` agrees, and ``KNOWN_AXES`` is the port's
  ``parallel/mesh.py`` vocabulary (AST, as the reference pins its own)."""

import ast
import dataclasses
import json
import os

import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.plan import ir as ref_ir  # noqa: E402
from tpu_dist.plan import tune as ref_tune  # noqa: E402
from tpu_dist_torch.plan import ir  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BAD = [   # the reference's illegal combinations (tests/test_plan.py:70-104)
    dict(engine="lm", quant="int4"),
    dict(engine="lm", tp_impl="ring"),
    dict(engine="lm", grad_bucket_mb=25.0),
    dict(engine="lm", layout="sp"),
    dict(engine="lm", layout="tp", sync="explicit"),
    dict(engine="lm", grad_accum_steps=2, steps_per_dispatch=4,
         window="indexed"),
    dict(engine="lm", adasum=True, sync="explicit"),
    dict(engine="lm", window="stacked"),
    dict(engine="image", layout="sp", sync="explicit"),
    dict(engine="image", loss_chunk=64),
    dict(engine="image", window="indexed", sync="explicit"),
    dict(engine="lm", quant_block=(100, 128, 0)),
    dict(engine="lm", quant_block=(128, 64, 0)),
    dict(engine="lm", quant_block=(128, 128, 64)),
    dict(engine="lm", opt_block_rows=100),
]


@pytest.mark.parametrize("engine,devices", [("lm", 1), ("lm", 8),
                                            ("image", 1), ("image", 8)])
def test_json_and_hash_match_the_reference_over_the_space(engine, devices):
    space = ref_tune.default_space(engine, devices)
    assert space
    for ref_plan in space:
        plan = ir.Plan(**dataclasses.asdict(ref_plan)).validate()
        assert plan.to_json() == ref_plan.to_json()
        assert ir.plan_hash(plan) == ref_ir.plan_hash(ref_plan)
        assert ir.Plan.from_json(ref_plan.to_json()) == plan


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items() if k != "engine"))
def test_validation_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ref_ir.PlanError) as want:
        ref_ir.Plan(**kw).validate()
    with pytest.raises(ir.PlanError) as got:
        ir.Plan(**kw).validate()
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_legal_edges_and_mesh_validation_agree():
    # the image explicit step may bucket while ring-pmean'ing over 'model'
    kw = dict(engine="image", sync="explicit", layout="tp", tp_impl="ring",
              grad_bucket_mb=25.0)
    assert ir.Plan(**kw).validate().to_json() == \
        ref_ir.Plan(**kw).validate().to_json()
    ring = dict(engine="lm", layout="tp", sync="explicit", tp_impl="ring")
    ir.Plan(**ring).validate_against_mesh({"data": 4, "model": 2})
    for shape, kw in (({"data": 8}, ring),
                      ({"batch": 8}, dict(engine="lm"))):
        with pytest.raises(ref_ir.PlanError) as want:
            ref_ir.Plan(**kw).validate_against_mesh(shape)
        with pytest.raises(ir.PlanError) as got:
            ir.Plan(**kw).validate_against_mesh(shape)
        assert str(got.value) == str(want.value)


def test_roundtrip_hash_and_from_dict_refusals():
    p = ir.Plan(engine="lm", quant="int8", sync="explicit",
                grad_bucket_mb=25.0, window="indexed", steps_per_dispatch=16,
                quant_block=(256, 128, 0), opt_block_rows=1024).validate()
    q = ir.Plan.from_json(p.to_json())
    assert q == p and hash(q) == hash(p) and ir.plan_hash(q) == ir.plan_hash(p)
    shuffled = dict(sorted(p.to_dict().items(), reverse=True))
    assert ir.plan_hash(ir.Plan.from_dict(shuffled)) == ir.plan_hash(p)
    assert ir.plan_hash(ir.Plan(engine="lm", quant="int8", fused_quant="on")) \
        != ir.plan_hash(ir.Plan(engine="lm", quant="int8"))
    for bad in ({**p.to_dict(), "version": 2}, {**p.to_dict(), "qant": 1},
                {**p.to_dict(), "quant_block": [128, 128]}):
        with pytest.raises(ref_ir.PlanError) as want:
            ref_ir.Plan.from_dict(bad)
        with pytest.raises(ir.PlanError) as got:
            ir.Plan.from_dict(bad)
        assert str(got.value) == str(want.value)


def test_known_axes_match_the_port_mesh():
    tree = ast.parse(open(os.path.join(
        REPO, "tpu_dist_torch", "parallel", "mesh.py")).read())
    axes = [n.value.value for n in ast.walk(tree)
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and n.targets[0].id.endswith("_AXIS")
            and isinstance(n.value, ast.Constant)]
    assert tuple(axes) == ir.KNOWN_AXES == ref_ir.KNOWN_AXES


def test_plan_files_are_interchangeable(tmp_path):
    """A file the reference's tuner writes loads in the port, and the
    other way round; device selection is exact key, substring, then
    'default'."""
    text, _ = ref_tune.tune(measurement_files=[
        os.path.join(REPO, "scripts", "tune_ci.json")])
    path = tmp_path / "ref.json"
    path.write_text(text)
    got, want = ir.load_plan_file(str(path)), ref_ir.load_plan_file(str(path))
    assert {k: v.to_json() for k, v in got.items()} == \
        {k: v.to_json() for k, v in want.items()}
    full = ir.Plan(engine="lm", quant="int8").to_dict()
    doc = {"version": 1, "plans": {"H100": full,
                                   "default": ir.Plan().to_dict()}}
    path.write_text(json.dumps(doc))
    plans = ir.load_plan_file(str(path))
    assert ir.plan_for_device(plans, "NVIDIA H100 80GB HBM3").quant == "int8"
    assert ir.plan_for_device(plans, "cpu").quant == "none"
    assert ref_ir.plan_for_device(ref_ir.load_plan_file(str(path)),
                                  "NVIDIA H100 80GB HBM3").quant == "int8"
    del plans["default"]
    with pytest.raises(ir.PlanError):
        ir.plan_for_device(plans, "cpu")
    path.write_text(json.dumps(full))
    assert ir.plan_for_device(ir.load_plan_file(str(path)), "x") == \
        ir.Plan.from_dict(full)


@pytest.mark.parametrize("engine", ["lm", "image"])
def test_apply_plan_to_config_matches_the_reference(engine):
    from tpu_dist import configs as ref_configs
    from tpu_dist_torch import configs

    name = "LMConfig" if engine == "lm" else "TrainConfig"
    kw = dict(engine=engine, quant="int8" if engine == "lm" else "none",
              sync="explicit", grad_bucket_mb=25.0, health="skip",
              opt_block_rows=1024)
    if engine == "lm":
        kw.update(window="indexed", steps_per_dispatch=16, loss_chunk=64)
    else:
        kw.update(grad_compression="bf16", predivide_factor=2.0)
    got = ir.apply_plan_to_config(getattr(configs, name)(), ir.Plan(**kw))
    want = ref_ir.apply_plan_to_config(getattr(ref_configs, name)(),
                                       ref_ir.Plan(**kw))
    gd, wd = dataclasses.asdict(got), dataclasses.asdict(want)
    changed = {k for k in wd if wd[k] != dataclasses.asdict(
        getattr(ref_configs, name)())[k]}
    assert changed and {k: gd[k] for k in changed} == \
        {k: wd[k] for k in changed}
    other = "image" if engine == "lm" else "lm"
    with pytest.raises(ir.PlanError, match="applied to"):
        ir.apply_plan_to_config(getattr(configs, name)(),
                                ir.Plan(engine=other))
    for plan in ref_tune.default_space(engine, 8):
        assert ir.plan_knob_summary(ir.Plan.from_json(plan.to_json())) == \
            ref_ir.plan_knob_summary(plan)
