"""Registry-enforced parity coverage for every public layer of the port.

The port's twin of ``tests/test_layer_oracle_enforcement.py``: it lists
the public layer classes of ``analytics_zoo_tpu_torch.pipeline.api.keras.
layers`` and fails when

1. a layer has no entry in ``PARITY_TESTS`` (a layer without a test that
   holds it against the JAX package),
2. an entry names a test function that does not exist in its file,
3. an entry names a layer the port no longer has, or
4. a port layer has no class of the same name in the reference's
   ``analytics_zoo_tpu.pipeline.api.keras.layers``;

and, the other way, when a class of the reference's ``conv``, ``core``,
``normalization`` or ``tensor_ops`` module has no class of its name in
the port's module.

Entry format: ``"LayerName": ("tests/<file>.py", "<test function>")``; the
test holds the port's layer against the JAX package's on the same inputs
(a parametrised test covers every layer named in its cases).
"""

import ast
import inspect
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CONV = ("tests/test_torch_conv_layers.py", "test_layer_matches_jax")
_REST = ("tests/test_torch_layers_rest.py", "test_layer_matches_jax")

PARITY_TESTS = {
    # ---- core -----------------------------------------------------------
    "Dense": ("tests/test_torch_layers.py",
              "test_sequential_dense_dropout_serves_like_jax"),
    "Dropout": ("tests/test_torch_layers.py", "test_dropout_trains_like_jax"),
    "Activation": _CONV,
    "Flatten": _CONV,
    "Reshape": _CONV,
    "Permute": _CONV,
    "RepeatVector": _CONV,
    "Identity": _CONV,
    "Squeeze": _CONV,
    "ExpandDim": _CONV,
    "Masking": _REST,
    "Highway": _REST,
    "Select": _REST,
    "MaxoutDense": _REST,
    "SparseDense": ("tests/test_torch_layers_rest.py",
                    "test_sparse_dense_coo_matches_jax"),
    "SpatialDropout1D": ("tests/test_torch_layers_rest.py",
                         "test_spatial_dropout_drops_whole_maps"),
    "SpatialDropout2D": ("tests/test_torch_layers_rest.py",
                         "test_spatial_dropout_drops_whole_maps"),
    "SpatialDropout3D": ("tests/test_torch_layers_rest.py",
                         "test_spatial_dropout_drops_whole_maps"),
    "GaussianNoise": ("tests/test_torch_layers_rest.py",
                      "test_gaussian_noise_statistics"),
    "GaussianDropout": ("tests/test_torch_layers_rest.py",
                        "test_gaussian_dropout_statistics"),
    # ---- convolution ----------------------------------------------------
    "Convolution1D": _CONV,
    "Convolution2D": _CONV,
    "Convolution3D": _CONV,
    "AtrousConvolution1D": _CONV,
    "AtrousConvolution2D": _CONV,
    "ZeroPadding1D": _CONV,
    "ZeroPadding2D": _CONV,
    "ZeroPadding3D": _CONV,
    "Cropping1D": _CONV,
    "Cropping2D": _CONV,
    "Cropping3D": _CONV,
    "UpSampling1D": _CONV,
    "UpSampling2D": _CONV,
    "UpSampling3D": _CONV,
    "DepthwiseConvolution2D": _REST,
    "SeparableConvolution2D": _REST,
    "Deconvolution2D": _REST,
    "LocallyConnected1D": _REST,
    "LocallyConnected2D": _REST,
    "ShareConvolution2D": _REST,
    # ---- pooling --------------------------------------------------------
    "MaxPooling1D": _CONV,
    "MaxPooling2D": _CONV,
    "MaxPooling3D": _CONV,
    "AveragePooling1D": _CONV,
    "AveragePooling2D": _CONV,
    "AveragePooling3D": _CONV,
    "GlobalMaxPooling1D": _CONV,
    "GlobalMaxPooling2D": _CONV,
    "GlobalMaxPooling3D": _CONV,
    "GlobalAveragePooling1D": _CONV,
    "GlobalAveragePooling2D": _CONV,
    "GlobalAveragePooling3D": _CONV,
    # ---- normalization and merge -----------------------------------------
    "BatchNormalization": ("tests/test_torch_batchnorm.py",
                           "test_batchnorm_training_steps_and_eval_match_jax"),
    "LayerNormalization": ("tests/test_torch_batchnorm.py",
                           "test_layernorm_matches_jax"),
    "WithinChannelLRN2D": _REST,
    "Merge": _CONV,
    # ---- tensor ops -----------------------------------------------------
    **{name: _REST for name in (
        "AddConstant", "MulConstant", "Negative", "Power", "Sqrt", "Square",
        "Exp", "Log", "BinaryThreshold", "Threshold", "HardShrink",
        "SoftShrink", "HardTanh", "Softmax", "CAdd", "CMul", "Scale", "Mul",
        "Expand", "Narrow", "Max", "SelectTable", "SplitTensor", "LRN2D",
        "ResizeBilinear")},
    "RReLU": ("tests/test_torch_layers_rest.py",
              "test_rrelu_slopes_are_uniform_in_training"),
    "GaussianSampler": ("tests/test_torch_layers_rest.py",
                        "test_gaussian_sampler_statistics"),
    "GetShape": ("tests/test_torch_layers_rest.py",
                 "test_get_shape_is_the_input_shape"),
    "SpaceToDepth": _CONV,
    # ---- transformer ----------------------------------------------------
    "TransformerLayer": ("tests/test_torch_layers.py",
                         "test_transformer_layer_matches_jax"),
    "BERT": ("tests/test_torch_bert_serving.py", "test_predict_matches_jax"),
}


def _public_layers(module, base):
    return sorted(n for n in dir(module) if not n.startswith("_")
                  and inspect.isclass(getattr(module, n))
                  and issubclass(getattr(module, n), base))


def _port_layers():
    import analytics_zoo_tpu_torch.pipeline.api.keras.layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Layer

    return _public_layers(L, Layer)


def _test_names_in(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    return {node.name for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name.startswith("test")}


def test_every_port_layer_has_a_parity_test():
    missing = [n for n in _port_layers() if n not in PARITY_TESTS]
    assert not missing, (
        f"{len(missing)} port layers have no parity test: add one and "
        f"register it in PARITY_TESTS: {missing}")


def test_registry_entries_point_at_real_tests():
    broken = []
    names = {}
    for layer, (path, test) in sorted(PARITY_TESTS.items()):
        if path not in names:
            full = os.path.join(REPO, path)
            names[path] = _test_names_in(path) if os.path.exists(full) \
                else None
        if names[path] is None:
            broken.append(f"{layer}: file {path} does not exist")
        elif test not in names[path]:
            broken.append(f"{layer}: {path} has no test {test!r}")
    assert not broken, "\n".join(broken)


def test_registry_has_no_stale_entries():
    public = set(_port_layers())
    stale = sorted(n for n in PARITY_TESTS if n not in public)
    assert not stale, f"the registry names layers the port lacks: {stale}"


def test_every_port_layer_has_a_reference_counterpart():
    import analytics_zoo_tpu.pipeline.api.keras.layers as J
    from analytics_zoo_tpu.pipeline.api.keras.engine import Layer as JLayer

    reference = set(_public_layers(J, JLayer))
    extra = sorted(n for n in _port_layers() if n not in reference)
    assert not extra, f"port layers with no reference class: {extra}"


def test_the_reference_layer_modules_are_whole_in_the_port():
    """Every class of the reference's ``conv``, ``core``, ``normalization``
    and ``tensor_ops`` layer modules has a class of the same name in the
    port's module of the same name."""
    import importlib

    missing = []
    for mod in ("conv", "core", "normalization", "tensor_ops"):
        ref = importlib.import_module(
            f"analytics_zoo_tpu.pipeline.api.keras.layers.{mod}")
        port = importlib.import_module(
            f"analytics_zoo_tpu_torch.pipeline.api.keras.layers.{mod}")
        for name, obj in vars(ref).items():
            if inspect.isclass(obj) and obj.__module__ == ref.__name__ \
                    and not inspect.isclass(getattr(port, name, None)):
                missing.append(f"{mod}.{name}")
    assert not missing, f"reference classes the port lacks: {missing}"
