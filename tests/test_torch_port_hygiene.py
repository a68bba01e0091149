"""The port stands alone: no JAX, no reference package, no silent CPU.

Importing every module of ``analytics_zoo_tpu_torch`` must leave ``jax``
and ``analytics_zoo_tpu`` out of ``sys.modules``.  That is checked in a
fresh interpreter, because this test process already imported JAX
(tests/conftest.py).  The entry points default to ``cuda`` and raise when
no GPU is visible, unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import analytics_zoo_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "analytics_zoo_tpu"))
print(len(names), bad)
"""


def _is_reference(name):
    return name.split(".")[0] in ("jax", "jaxlib", "analytics_zoo_tpu")


def test_importing_every_module_pulls_in_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(n) >= 20 and bad == "[]", res.stdout


@pytest.mark.parametrize("path", [
    "chip_smoke.py",
    *sorted(os.path.relpath(os.path.join(d, f), REPO)
            for d, _, fs in os.walk(os.path.join(REPO,
                                                 "analytics_zoo_tpu_torch"))
            for f in fs if f.endswith(".py")),
])
def test_sources_import_nothing_of_the_reference(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(_is_reference(a.name) for a in node.names), path
        elif isinstance(node, ast.ImportFrom) and node.module:
            assert not _is_reference(node.module), path


def test_entry_points_default_to_cuda_and_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    from analytics_zoo_tpu_torch import init_zoo_context
    from analytics_zoo_tpu_torch.common import engine
    from analytics_zoo_tpu_torch.convert import params_from_jax

    saved = engine._CONTEXT
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_zoo_context()
        engine._CONTEXT = None
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine.get_zoo_context()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax({"w": [1.0]})
        assert init_zoo_context(device="cpu").device.type == "cpu"
    finally:
        engine._CONTEXT = saved


def test_model_without_gpu_raises_unless_cpu_requested():
    from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense

    x = Input((4,))
    net = Model(x, Dense(2)(x))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            net.build_params(rng=torch.Generator().manual_seed(0),
                             device="cuda")
    net.build_params(rng=torch.Generator().manual_seed(0), device="cpu")
    assert net.device.type == "cpu"
    assert {k: v.shape for k, v in net.params["dense_0"].items()} == \
        {"kernel": (4, 2), "bias": (2,)}


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


#: the modules of the estimator plane and the importers, as the JAX
#: package names them
ESTIMATOR_AND_IMPORTER_MODULES = (
    "tfpark.estimator", "tfpark.text.estimator",
    "tfpark.text.estimator.bert_base",
    "tfpark.text.estimator.bert_classifier",
    "tfpark.text.estimator.bert_ner", "tfpark.text.estimator.bert_squad",
    "tfpark.gan", "tfpark.gan.gan_estimator", "pipeline.api.onnx",
    "pipeline.api.onnx.proto", "pipeline.api.onnx.mapper",
    "pipeline.api.onnx.export", "models.caffe", "pipeline.api.net",
    "pipeline.api.net.torch_net", "pipeline.api.net.tf_net")


@pytest.mark.parametrize("module", ESTIMATOR_AND_IMPORTER_MODULES)
def test_reference_module_names_are_whole_in_the_port(module):
    """Every public class and function the reference module defines or
    exports (and the private helpers other modules reach for) has a port
    counterpart of its name in the port's module of the same name."""
    import importlib
    import inspect

    ref = importlib.import_module(f"analytics_zoo_tpu.{module}")
    port = importlib.import_module(f"analytics_zoo_tpu_torch.{module}")
    helpers = {"_squad_loss", "_token_softmax", "_MergedFeatureSet",
               "_stack_all", "_load_init_checkpoint", "_Fixed",
               "_iter_fields", "_read_varint", "_put_bytes", "_put_varint"}
    names = set(getattr(ref, "__all__", ()))
    for name, obj in vars(ref).items():
        if (inspect.isclass(obj) or inspect.isfunction(obj)) \
                and obj.__module__ == ref.__name__ \
                and (not name.startswith("_") or name in helpers):
            names.add(name)
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, f"{module}: the port lacks {missing}"
    assert not _is_reference(port.__name__)
