"""The port's SSD stack (``models/image/objectdetection``) against the JAX
package's: priors, IoU, box coding and bipartite matching (a contended
best prior, padding), the MultiBox loss and its gradient (tied negatives
pick the same priors), ``L2Normalize2D``, the ``ssd_tiny`` forward with the
reference's weights, ``ssd_vgg300``'s parameter tree, the postprocess, the
mAP functions and the VOC/COCO readers; and one ``ssd-tiny`` fit in the
port whose loss falls."""

import json
import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.engine import init_zoo_context
from analytics_zoo_tpu_torch.common.utils import tree_map
from analytics_zoo_tpu_torch.convert import params_from_jax
from analytics_zoo_tpu_torch.models.image.objectdetection import (
    MultiBoxLoss,
    ObjectDetector,
    PriorSpec,
    SSD300_SPECS,
    decode_boxes,
    detect,
    encode_boxes,
    generate_priors,
    iou_matrix,
    match_priors,
    mean_average_precision,
    pad_ground_truth,
    ssd_tiny,
    ssd_vgg300,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.priors import (
    center_to_corner,
)

SEED = 11
TINY_SPECS = [PriorSpec(8, 0.15, 0.3, (2.0,)), PriorSpec(4, 0.3, 0.6, (2.0,))]
LOSS_TOL = 1e-5   # relative: the loss, and the gradient to its largest entry
FWD_TOL = 1e-5    # relative to the output's largest entry
BOX_TOL = 1e-6


@pytest.fixture(autouse=True)
def _contexts():
    import analytics_zoo_tpu.common.engine as jax_engine
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu import init_zoo_context as jax_init

    saved = (jax_engine._CONTEXT, torch_engine._CONTEXT)
    jax_init(seed=SEED, mesh_shape={"data": 1})
    init_zoo_context(seed=SEED, device="cpu")
    yield
    jax_engine._CONTEXT, torch_engine._CONTEXT = saved


def _ref():
    import analytics_zoo_tpu.models.image.objectdetection as ref

    return ref


def _boxes(gen, n, lo=0.0, hi=1.0):
    """``n`` random corner boxes inside [lo, hi]."""
    a = gen.uniform(lo, hi, (n, 2, 2))
    return np.concatenate([a.min(1), a.max(1)], -1).astype(np.float32)


def _gt(gen, b, max_boxes, real):
    """(B, max_boxes, 5) padded ground truth with ``real[i]`` boxes."""
    boxes = [_boxes(gen, k, 0.05, 0.95) for k in real]
    labels = [gen.integers(0, 3, k) for k in real]
    return pad_ground_truth(boxes, labels, max_boxes)


def test_priors_match_the_reference():
    ref = _ref()
    for specs in (SSD300_SPECS, TINY_SPECS):
        rspecs = [ref.PriorSpec(s.fm_size, s.min_size, s.max_size,
                                s.aspect_ratios) for s in specs]
        got, want = generate_priors(specs), ref.generate_priors(rspecs)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(center_to_corner(got),
                                      ref.priors.center_to_corner(want))
    assert generate_priors(SSD300_SPECS).shape == (8732, 4)
    assert [s.boxes_per_loc for s in SSD300_SPECS] == [4, 6, 6, 6, 4, 4]


def test_iou_and_box_coding_match_the_reference():
    import jax.numpy as jnp

    ref = _ref()
    gen = np.random.default_rng(1)
    a, b = _boxes(gen, 37), _boxes(gen, 9)
    a[3] = a[4] = [0.2, 0.2, 0.2, 0.6]  # zero area: union 0 against itself
    np.testing.assert_allclose(
        iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref.iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=BOX_TOL)
    priors = generate_priors(TINY_SPECS)
    matched = _boxes(gen, len(priors), 0.05, 0.95)
    t_enc = encode_boxes(torch.from_numpy(matched), torch.from_numpy(priors))
    j_enc = ref.encode_boxes(jnp.asarray(matched), jnp.asarray(priors))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc),
                               rtol=BOX_TOL, atol=BOX_TOL)
    loc = gen.normal(0, 1, (len(priors), 4)).astype(np.float32)
    np.testing.assert_allclose(
        decode_boxes(torch.from_numpy(loc), torch.from_numpy(priors)).numpy(),
        np.asarray(ref.decode_boxes(jnp.asarray(loc), jnp.asarray(priors))),
        rtol=BOX_TOL, atol=BOX_TOL)
    # decode inverts encode
    np.testing.assert_allclose(
        decode_boxes(t_enc, torch.from_numpy(priors)).numpy(), matched,
        rtol=1e-4, atol=1e-5)


def _match_both(gt, priors_center, threshold=0.5):
    """Both packages' matching of a (B, M, 5) batch: the port's batched
    loop against the reference's per-image function under ``vmap``."""
    import jax
    import jax.numpy as jnp

    ref = _ref()
    corner = center_to_corner(priors_center).astype(np.float32)
    conf, matched = match_priors(torch.from_numpy(gt[..., :4]),
                                 torch.from_numpy(gt[..., 4]).long(),
                                 torch.from_numpy(corner), threshold)
    want_conf, want_matched = jax.jit(jax.vmap(
        lambda g: ref.match_priors(g[:, :4], g[:, 4].astype(jnp.int32),
                                   jnp.asarray(corner), threshold)))(
        jnp.asarray(gt))
    return (conf.numpy(), matched.numpy(), np.asarray(want_conf),
            np.asarray(want_matched))


def test_matching_matches_the_reference_over_a_batch():
    gen = np.random.default_rng(2)
    gt = _gt(gen, 6, 8, real=[1, 3, 8, 0, 5, 2])
    conf, matched, w_conf, w_matched = _match_both(
        gt, generate_priors(TINY_SPECS))
    np.testing.assert_array_equal(conf, w_conf)
    np.testing.assert_allclose(matched, w_matched, rtol=0, atol=BOX_TOL)
    assert (conf[3] == 0).all()  # an image of padding only: background
    # every real gt owns a positive prior that regresses to it (the force
    # match gives each its own)
    for i, k in enumerate([1, 3, 8, 0, 5, 2]):
        owned = matched[i][conf[i] > 0]
        for j in range(k):
            assert (owned == gt[i, j, :4]).all(-1).any(), (i, j)


def test_a_contended_best_prior_goes_to_one_gt_each():
    """Two gts whose best prior is the same prior: the bipartite pass
    gives each its own prior in both packages (a plain argmax drops one);
    single-image calls agree with the batched loop."""
    priors = np.asarray([[0.25, 0.25, 0.5, 0.5], [0.8, 0.8, 0.2, 0.2]],
                        np.float32)
    gt = np.asarray([[[0.0, 0.0, 0.5, 0.5, 0], [0.0, 0.0, 0.45, 0.45, 1],
                      [0, 0, 0, 0, -1]]], np.float32)
    conf, matched, w_conf, w_matched = _match_both(gt, priors)
    np.testing.assert_array_equal(conf, w_conf)
    np.testing.assert_allclose(matched, w_matched, rtol=0, atol=BOX_TOL)
    assert sorted(conf[0].tolist()) == [1, 2]
    one, _ = match_priors(torch.from_numpy(gt[0, :, :4]),
                          torch.from_numpy(gt[0, :, 4]).long(),
                          torch.from_numpy(center_to_corner(priors)))
    np.testing.assert_array_equal(one.numpy(), conf[0])


def _loss_both(y_true, y_pred, priors, n_classes=3):
    import jax
    import jax.numpy as jnp

    ref = _ref()
    jloss = ref.MultiBoxLoss(priors, n_classes)
    yt = jnp.asarray(y_true)

    @jax.jit
    def value_and_grad(yp):
        return jloss._fn(yt, yp), jax.grad(
            lambda p: jnp.mean(jloss._fn(yt, p)))(yp)

    want_per, jgrad = value_and_grad(jnp.asarray(y_pred))
    tloss = MultiBoxLoss(priors, n_classes)
    yp = torch.from_numpy(y_pred).requires_grad_(True)
    per = tloss(torch.from_numpy(y_true), yp)
    per.mean().backward()
    return (per.detach().numpy(), yp.grad.numpy(), np.asarray(want_per),
            np.asarray(jgrad))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def test_multibox_loss_and_gradient_match_the_reference():
    gen = np.random.default_rng(4)
    priors = generate_priors(TINY_SPECS)
    y_true = _gt(gen, 4, 6, real=[2, 6, 1, 4])
    y_pred = gen.normal(0, 1, (4, len(priors), 4 + 4)).astype(np.float32)
    per, grad, want_per, want_grad = _loss_both(y_true, y_pred, priors)
    assert _rel(per, want_per) < LOSS_TOL, (per, want_per)
    assert _rel(grad, want_grad) < LOSS_TOL
    # the mining selected the same priors: the same non-zero pattern
    np.testing.assert_array_equal(grad[..., 4:] != 0,
                                  want_grad[..., 4:] != 0)


def test_tied_negatives_pick_the_same_priors():
    """Equal class logits give every negative the same loss: the stable
    argsort of argsort keeps the lowest-index negatives in both packages
    (the gradient of the logits is non-zero exactly at the priors kept)."""
    gen = np.random.default_rng(5)
    priors = generate_priors(TINY_SPECS)
    y_true = _gt(gen, 3, 4, real=[1, 2, 3])
    y_pred = np.zeros((3, len(priors), 8), np.float32)
    y_pred[..., :4] = gen.normal(0, 0.5, (3, len(priors), 4))
    per, grad, want_per, want_grad = _loss_both(y_true, y_pred, priors)
    assert _rel(per, want_per) < LOSS_TOL
    kept = np.abs(grad[..., 4:]).sum(-1) != 0
    np.testing.assert_array_equal(
        kept, np.abs(want_grad[..., 4:]).sum(-1) != 0)
    assert _rel(grad, want_grad) < LOSS_TOL
    conf, _, _, _ = _match_both(y_true, priors)
    for i in range(3):
        pos = conf[i] > 0
        negs = np.flatnonzero(kept[i] & ~pos)
        n_neg = min(3 * int(pos.sum()), int((~pos).sum()))
        assert negs.tolist() == np.flatnonzero(~pos)[:n_neg].tolist()


def test_l2normalize2d_matches_jax():
    import jax.numpy as jnp

    from analytics_zoo_tpu.models.image.objectdetection.ssd import (
        L2Normalize2D as JNorm,
    )
    from analytics_zoo_tpu_torch.models.image.objectdetection.ssd import (
        L2Normalize2D,
    )

    gen = np.random.default_rng(6)
    x = gen.normal(0, 1, (2, 5, 5, 8)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero pixel: the 1e-10 keeps it finite
    layer, jlayer = L2Normalize2D(), JNorm()
    layer.ensure_built((5, 5, 8))
    jlayer.ensure_built((5, 5, 8))
    init = layer.init_params(torch.Generator().manual_seed(0))
    assert init["scale"].shape == (8,) and (init["scale"] == 20.0).all()
    scale = gen.uniform(5, 25, 8).astype(np.float32)
    got = layer.call({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = jlayer.call({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert layer.get_config() == jlayer.get_config() == {"scale_init": 20.0}


def _ssd_pair(n_classes=3):
    import jax
    import jax.numpy as jnp

    ref = _ref()
    tnet, tpriors = ssd_tiny(n_classes)
    jnet, jpriors = ref.ssd_tiny(n_classes)
    np.testing.assert_array_equal(tpriors, jpriors)
    tnet.build_params()
    shapes = jax.eval_shape(jnet.init_params, jax.random.PRNGKey(SEED))
    assert _paths(tnet.params) == _paths(shapes)
    weights = tree_map(lambda t: t.numpy(), tnet.params)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, weights)
    jnet.state = {}
    tnet.set_weights(params_from_jax(weights, device="cpu"))
    return tnet, jnet


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = (tuple(v.shape),
                                    str(v.dtype).replace("torch.", ""))
    return out


def test_ssd_tiny_forward_matches_the_reference():
    import jax.numpy as jnp

    tnet, jnet = _ssd_pair()
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    got, _ = tnet.forward(tnet.params, torch.from_numpy(x), state=tnet.state)
    want, _ = jnet.forward(jnet.params, jnp.asarray(x), state=jnet.state)
    assert got.shape == (2, 8 * 8 * 4 + 4 * 4 * 4, 4 + 4)
    assert _rel(got.detach().numpy(), np.asarray(want)) < FWD_TOL


def test_ssd_vgg300_tree_matches_the_reference():
    """The full SSD300's tree, names and shapes, from the port's weight
    specs (nothing drawn) against the reference's ``init_params`` traced
    with ``jax.eval_shape`` (nothing compiled)."""
    import jax

    ref = _ref()
    tnet, priors = ssd_vgg300(20)
    jnet, jpriors = ref.ssd_vgg300(20)
    np.testing.assert_array_equal(priors, jpriors)
    port = {}
    for layer in tnet.layers:
        for spec in layer._weight_specs + layer._state_specs:
            port[f"/{layer.name}/{spec.name}"] = (
                spec.shape, str(spec.dtype).replace("torch.", ""))
    shapes = jax.eval_shape(jnet.init_params, jax.random.PRNGKey(0))
    assert port == _paths(shapes)
    assert port["/conv4_3_norm/scale"] == ((512,), "float32")
    assert sum(int(np.prod(s)) for s, _ in port.values()) > 2.6e7


def test_detect_matches_the_reference():
    ref = _ref()
    gen = np.random.default_rng(8)
    priors = generate_priors(TINY_SPECS)
    y_pred = gen.normal(0, 2, (3, len(priors), 8)).astype(np.float32)
    got = detect(y_pred, priors, conf_threshold=0.3, top_k=50)
    want = ref.detect(y_pred, priors, conf_threshold=0.3, top_k=50)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=1e-6,
                                   atol=1e-6)
    assert sum(len(g["scores"]) for g in got) > 0
    # a torch tensor is decoded on its own device
    t_out = detect(torch.from_numpy(y_pred), priors, conf_threshold=0.3,
                   top_k=50)
    np.testing.assert_array_equal(t_out[0]["classes"], got[0]["classes"])
    img = np.zeros((40, 50, 3), np.uint8)
    drawn = ObjectDetector("ssd-tiny", class_names=("a", "b", "c")) \
        .visualize(img, got[0], score_threshold=0.0)
    np.testing.assert_array_equal(
        drawn, ref.visualize(img, want[0], score_threshold=0.0))


def test_map_functions_match_the_reference():
    ref = _ref()
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        PascalVocEvaluator,
        average_precision,
    )

    gen = np.random.default_rng(9)
    dets, gts = [], []
    for _ in range(6):
        k = int(gen.integers(1, 4))
        g = _boxes(gen, k, 0.0, 1.0)
        gts.append(dict(boxes=g, classes=gen.integers(0, 3, k),
                        difficult=gen.random(k) < 0.2))
        noisy = np.clip(np.concatenate([g, _boxes(gen, 2)]) + gen.normal(
            0, 0.03, (k + 2, 4)), 0, 1).astype(np.float32)
        dets.append(dict(boxes=noisy, scores=gen.random(k + 2),
                         classes=gen.integers(0, 3, k + 2)))
    for use_07 in (False, True):
        for thr in (0.3, 0.5):
            assert [average_precision(dets, gts, c, thr, use_07)
                    for c in range(4)] == pytest.approx(
                [ref.average_precision(dets, gts, c, thr, use_07)
                 for c in range(4)], nan_ok=True, rel=0, abs=0)
            assert mean_average_precision(dets, gts, 4, thr, use_07) == \
                ref.mean_average_precision(dets, gts, 4, thr, use_07)
    names = ("a", "b", "c")
    assert PascalVocEvaluator(names).evaluate(dets, gts) == \
        ref.PascalVocEvaluator(names).evaluate(dets, gts)


def write_voc_devkit(root, n, classes, size=(48, 64), seed=0):
    """A VOC devkit of ``n`` JPEGs with 1-3 boxes each of ``classes`` and
    their XML annotations under ``root/VOC2007``."""
    from PIL import Image

    gen = np.random.default_rng(seed)
    base = os.path.join(root, "VOC2007")
    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                        "Main")):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = []
    for i in range(n):
        idx = f"{i:06d}"
        ids.append(idx)
        h, w = size
        Image.fromarray(gen.integers(0, 255, (h, w, 3), dtype=np.uint8)) \
            .save(os.path.join(base, "JPEGImages", idx + ".jpg"))
        objs = []
        for _ in range(int(gen.integers(1, 4))):
            x0, y0 = int(gen.integers(0, w // 2)), int(gen.integers(0, h // 2))
            x1, y1 = x0 + int(gen.integers(4, w // 2)), \
                y0 + int(gen.integers(4, h // 2))
            objs.append(
                f"<object><name>{classes[int(gen.integers(len(classes)))]}"
                f"</name><difficult>{int(gen.random() < 0.2)}</difficult>"
                f"<bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}"
                f"</xmax><ymax>{y1}</ymax></bndbox></object>")
        with open(os.path.join(base, "Annotations", idx + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}"
                    f"</height></size>{''.join(objs)}</annotation>")
    with open(os.path.join(base, "ImageSets", "Main", "train.txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")
    return root


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            if isinstance(g[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


def test_voc_reader_matches_the_reference(tmp_path):
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        VOC_CLASSES,
        PascalVoc,
    )

    ref = _ref()
    root = write_voc_devkit(str(tmp_path), 4, VOC_CLASSES[1:], seed=1)
    _same_records(PascalVoc(root).roidb(), ref.PascalVoc(root).roidb())
    assert VOC_CLASSES == ref.VOC_CLASSES
    with pytest.raises(FileNotFoundError):
        PascalVoc(str(tmp_path / "none"))


def test_coco_readers_match_the_reference(tmp_path):
    from PIL import Image

    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        COCO_CAT_ID_TO_IND,
        Coco,
    )

    ref = _ref()
    gen = np.random.default_rng(10)
    imgs, anns = [], []
    for i in range(3):
        Image.fromarray(gen.integers(0, 255, (32, 48, 3), dtype=np.uint8)) \
            .save(tmp_path / f"im{i}.jpg")
        imgs.append({"id": i, "file_name": f"im{i}.jpg", "width": 48,
                     "height": 32})
        anns.append({"id": 10 + i, "image_id": i, "category_id": 3,
                     "bbox": [4, 5, 20, 15], "area": 300, "iscrowd": i % 2})
    anns.append({"id": 99, "image_id": 0, "category_id": 3,
                 "bbox": [4, 5, 0, 0], "area": 0, "iscrowd": 0})
    anns.append({"id": 98, "image_id": 0, "category_id": 12,
                 "bbox": [1, 1, 5, 5], "area": 25, "iscrowd": 0})
    anns.append({"id": 97, "image_id": 1, "category_id": 1,
                 "bbox": [40, 20, 30, 30], "area": 900, "iscrowd": 0})
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": imgs, "annotations": anns}))
    _same_records(Coco(str(tmp_path), instances_json=str(path)).roidb(),
                  ref.Coco(str(tmp_path), instances_json=str(path)).roidb())
    # the devkit layout: ImageSets/<set>.txt of "<image> <annotation>"
    (tmp_path / "ImageSets").mkdir()
    for i in range(2):
        (tmp_path / f"a{i}.json").write_text(json.dumps({
            "image": {"width": 48, "height": 32},
            "annotation": [a for a in anns if a["image_id"] == i]}))
    (tmp_path / "ImageSets" / "train.txt").write_text(
        "".join(f"im{i}.jpg a{i}.json\n" for i in range(2)))
    _same_records(Coco(str(tmp_path)).roidb(),
                  ref.Coco(str(tmp_path)).roidb())
    assert COCO_CAT_ID_TO_IND == ref.COCO_CAT_ID_TO_IND


def _toy_dataset(n=64, size=64, seed=0):
    """One bright square per image; the class is its colour channel."""
    gen = np.random.default_rng(seed)
    images = np.zeros((n, size, size, 3), np.float32)
    boxes, labels = [], []
    for i in range(n):
        cls = int(gen.integers(0, 2))
        s = int(gen.integers(14, 22))
        x0, y0 = (int(gen.integers(0, size - s)) for _ in range(2))
        images[i, y0:y0 + s, x0:x0 + s, cls] = 1.0
        boxes.append([[x0 / size, y0 / size, (x0 + s) / size,
                       (y0 + s) / size]])
        labels.append([cls])
    return images, boxes, labels


@pytest.fixture(scope="module")
def fitted():
    """One ``ssd-tiny`` fit in the port, shared by the cases below: the
    mean loss on 8 images before and after, and the detector."""
    import analytics_zoo_tpu_torch.common.engine as torch_engine
    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

    saved = torch_engine._CONTEXT
    init_zoo_context(seed=SEED, device="cpu")
    det = ObjectDetector("ssd-tiny", class_names=("red", "green"))
    images, boxes, labels = _toy_dataset()
    y = torch.from_numpy(pad_ground_truth(boxes, labels, max_boxes=4)[:8])
    loss_fn = det.loss()
    det.model.build_params()

    def mean_loss():
        out, _ = det.model.forward(det.model.params,
                                   torch.from_numpy(images[:8]),
                                   state=det.model.state)
        return float(loss_fn(y, out).mean())

    before = mean_loss()
    det.compile(Adam(lr=1e-3))
    det.fit_detection(images, boxes, labels, batch_size=16, nb_epoch=30,
                      max_boxes=4)
    after = mean_loss()
    torch_engine._CONTEXT = saved
    return det, before, after, images, boxes, labels


def test_ssd_tiny_fit_loss_falls(fitted):
    _, before, after, *_ = fitted
    assert np.isfinite(before) and after < 0.5 * before, (before, after)


def test_fitted_ssd_tiny_detects(fitted):
    det, _, _, images, boxes, labels = fitted
    dets = det.predict_image_set(images[:8], conf_threshold=0.3)
    # decoded batch by batch on the model's device: the same detections as
    # detect over predict's raw output
    again = detect(det.model.predict(images[:8]), det.priors, 0.3)
    for d, a in zip(dets, again, strict=True):
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(d[k], a[k])
    gts = [dict(boxes=np.asarray(boxes[i], np.float32),
                classes=np.asarray(labels[i])) for i in range(8)]
    assert mean_average_precision(dets, gts, 2, iou_threshold=0.3) > 0.25
