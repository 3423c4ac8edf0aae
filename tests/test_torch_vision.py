"""Port vision stack (``vision/backbones.py``, ``vision/extractors.py``,
``vision/dataset.py``, ``cli/extract_features.py``) vs the JAX package's,
on the CPU: a twin of each test of ``tests/test_vision.py``, run on the
same numpy / torch-seeded inputs through the JAX function and the port's.

- backbone outputs from JAX params carried across (``models/convert.py``)
  or from the same torchvision-layout state dict: rtol 1e-4, atol 1e-4
  (the JAX importers' own tolerance, ``tests/test_vision.py``);
- the two slow JAX shape tests run here at 32x32, B = 2, JAX eagerly;
- the low-level extractor, histograms, one-hots, colors and edge tiffs
  bit-equal; texture grams rtol 1e-4, atol 1e-6;
- the extraction CLI file for file against JAX's on the same 4
  images and the same weights (``--torch_weights``): the same names, the
  low-level files and one-hots byte-equal, CNN features rtol 1e-4, atol
  1e-4, the CSV's ids, classes and class numbers equal and ``Prob`` rtol
  1e-5;
- the pandas / sklearn stand-ins of the CLI (the classes CSV writer
  and reader, ``label_binarize``) against pandas and sklearn themselves."""

import io
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from fashionvisualexpl_tpu.vision import backbones as JB
from fashionvisualexpl_tpu.vision import extractors as JE
from fashionvisualexpl_tpu_torch.models.convert import resnet_from_jax, vgg19_from_jax
from fashionvisualexpl_tpu_torch.vision import backbones as PB
from fashionvisualexpl_tpu_torch.vision import extractors as PE
from tests.test_vision import (
    _np_sd,
    _torch_resnet_forward,
    _torch_resnet_sd,
    _torch_vgg19_forward,
    _torch_vgg19_sd,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def np_params(params):
    return jax.tree.map(np.asarray, params)


def run(fn, x):
    with torch.no_grad():
        return fn(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def test_resnet50_shapes():
    """test_vision.py::test_resnet50_shapes at 32x32, JAX eagerly: JAX's
    init carried across, every output against JAX's."""
    net = JB.ResNet()
    params = net.init(jax.random.PRNGKey(0))
    port = resnet_from_jax(np_params(params), PB.RESNET50_BLOCKS, device="cpu")
    x = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    feats = run(port.apply, x)
    assert feats.shape == (2, 2048) and np.isfinite(feats).all()
    np.testing.assert_allclose(feats, np.asarray(net.apply(params, x)), **TOL)
    logits = run(lambda t: port.apply(t, with_head=True), x)
    assert logits.shape == (2, 1000)
    np.testing.assert_allclose(logits, np.asarray(net.apply(params, x, with_head=True)), **TOL)
    spat = run(port.spatial_features, x)
    assert spat.shape == (2, 1, 1, 2048)  # 32 / (2*2*2*2*2)
    np.testing.assert_allclose(spat, np.asarray(net.spatial_features(params, x)), **TOL)


def test_resnet_train_mode_batch_norm():
    """``train=True``: the batch's mean and biased variance, as JAX's _bn."""
    blocks = (1, 1, 1, 1)
    net = JB.ResNet(blocks)
    params = net.init(jax.random.PRNGKey(2))
    port = resnet_from_jax(np_params(params), blocks, device="cpu")
    # 64x64 and B = 4: 16 values a channel at the last stage (at 32x32 and
    # B = 3, three: their variance cancels and amplifies any rounding)
    x = np.random.default_rng(2).random((4, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(run(lambda t: port.apply(t, train=True), x),
                               np.asarray(net.apply(params, x, train=True)), **TOL)
    # the running statistics are left as they were
    assert all(float(b.sum()) in (0.0, b.numel()) for b in port.buffers())


@pytest.mark.parametrize("hw", [(32, 32), (20, 28)], ids=["32x32", "20x28"])
def test_vgg19_output_layers(hw):
    """Every output layer against JAX's; 20x28 pools odd sizes (SAME: the
    last row / column kept), so feat_hw rounds up to 1 x 1."""
    net = JB.VGG19(input_hw=hw)
    params = net.init(jax.random.PRNGKey(1))
    port = vgg19_from_jax(np_params(params), input_hw=hw, device="cpu")
    assert port.feat_hw == net.feat_hw and port.flat_dim == net.flat_dim
    x = np.random.default_rng(1).random((2, *hw, 3)).astype(np.float32)
    shapes = {"fc2": (2, 4096), "block5_pool": (2, 1, 1, 512), "predictions": (2, 1000)}
    for layer in PB.VGG19_LAYERS:
        got = run(lambda t: port.apply(t, output_layer=layer), x)
        want = np.asarray(net.apply(params, x, output_layer=layer))
        assert got.shape == want.shape == shapes.get(layer, want.shape), layer
        np.testing.assert_allclose(got, want, **TOL, err_msg=layer)


def test_torch_state_dict_import():
    """test_vision.py::test_torch_state_dict_import: the same synthetic
    torchvision-layout ResNet-50 state dict through both importers."""
    base_rng = np.random.default_rng(0)

    def normal(size):  # fan-in-scaled weights so 50 random layers don't overflow
        return (base_rng.normal(size=size) / np.sqrt(max(int(np.prod(size[1:])), 1))
                ).astype(np.float32)

    def bn(sd, pre, c):
        sd.update({f"{pre}.weight": np.ones(c, np.float32), f"{pre}.bias": np.zeros(c, np.float32),
                   f"{pre}.running_mean": np.zeros(c, np.float32),
                   f"{pre}.running_var": np.ones(c, np.float32)})

    sd = {"conv1.weight": normal((64, 3, 7, 7))}
    bn(sd, "bn1", 64)
    in_c = 64
    for s, (n, out_c) in enumerate(zip((3, 4, 6, 3), (256, 512, 1024, 2048))):
        mid = out_c // 4
        for b in range(n):
            t = f"layer{s + 1}.{b}"
            sd[f"{t}.conv1.weight"] = normal((mid, in_c, 1, 1))
            sd[f"{t}.conv2.weight"] = normal((mid, mid, 3, 3))
            sd[f"{t}.conv3.weight"] = normal((out_c, mid, 1, 1))
            for i, c in ((1, mid), (2, mid), (3, out_c)):
                bn(sd, f"{t}.bn{i}", c)
            if b == 0:
                sd[f"{t}.downsample.0.weight"] = normal((out_c, in_c, 1, 1))
                bn(sd, f"{t}.downsample.1", out_c)
            in_c = out_c
    sd["fc.weight"] = normal((1000, 2048))
    sd["fc.bias"] = np.zeros(1000, np.float32)

    net = JB.ResNet()
    params = JB.load_torch_resnet50_state_dict(net, sd)
    port = PB.load_torch_resnet50_state_dict(PB.ResNet(device="cpu"), sd)
    x = base_rng.random((1, 32, 32, 3)).astype(np.float32)
    out = run(port.apply, x)
    assert out.shape == (1, 2048) and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(net.apply(params, x)), **TOL)
    # OIHW kept as torchvision has it (JAX's HWIO is its transpose)
    assert tuple(port.stem_W.shape) == (64, 3, 7, 7)
    np.testing.assert_array_equal(port.stem_W.detach().numpy(), sd["conv1.weight"])
    np.testing.assert_array_equal(
        port.stem_W.detach().numpy(), np.transpose(np.asarray(params["stem_W"]), (3, 2, 0, 1)))


def test_low_feature_extractor_and_histogram():
    """Edge map, dominant colors and histogram bit-equal to JAX's, on the
    JAX test's image and on a uniform one (no contour)."""
    img = np.zeros((64, 64, 3), np.uint8)
    img[16:48, 16:48] = (200, 60, 60)
    for image in (img, np.full((32, 32, 3), 90, np.uint8)):
        edge_map, colors = PE.LowFeatureExtractor(num_colors=2).extract_color_edges((image, "0.jpg"))
        want_map, want_colors = JE.LowFeatureExtractor(num_colors=2).extract_color_edges(
            (image, "0.jpg"))
        assert edge_map.shape == image.shape[:2] and colors.shape == (6,)  # 2 colors x RGB
        np.testing.assert_array_equal(edge_map, want_map)
        np.testing.assert_array_equal(colors, want_colors)
        assert edge_map.dtype == want_map.dtype and colors.dtype == want_colors.dtype
        hist = PE.color_histogram(image)
        assert hist.shape == (512,) and hist.sum() > 0 and hist.dtype == np.int32
        np.testing.assert_array_equal(hist, JE.color_histogram(image))


def write_images(img_dir, n=4, hw=40):
    from PIL import Image

    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    for i in range(n):
        arr = np.zeros((hw, hw, 3), np.uint8)
        arr[8:32, 8:32] = rng.integers(50, 255, 3)
        Image.fromarray(arr).save(os.path.join(img_dir, f"{i}.jpg"))


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_image_folder_dataset_and_extraction_cli(tmp_path):
    """Both CLIs on the same 4 images with the same weights (a torchvision
    ResNet-50 state dict), file for file."""
    from fashionvisualexpl_tpu.cli.extract_features import extract as jax_extract
    from fashionvisualexpl_tpu.core.config import Paths
    from fashionvisualexpl_tpu.vision.dataset import ImageFolderDataset as JDataset
    from fashionvisualexpl_tpu_torch.cli.extract_features import extract
    from fashionvisualexpl_tpu_torch.vision.dataset import ImageFolderDataset

    weights = str(tmp_path / "resnet50.npz")
    np.savez(weights, **_np_sd(_torch_resnet_sd((3, 4, 6, 3), seed=1)))
    roots = {}
    for side, fn in (("jax", jax_extract), ("port", extract)):
        root = str(tmp_path / side)
        img_dir = Paths(root=root).images("mini")
        write_images(img_dir)
        open(os.path.join(img_dir, "notes.txt"), "w").close()  # a stray file, skipped
        argv = ["--dataset", "mini", "--data_root", root, "--cnn_model", "ResNet50",
                "--output_layer", "avg_pool", "--batch", "3", "--resize", "32",
                "--num_colors", "2", "--torch_weights", weights]
        fn(argv + (["--device", "cpu"] if side == "port" else []))
        roots[side] = root

    ds = ImageFolderDataset(Paths(root=roots["port"]).images("mini"), resize=(32, 32))
    jds = JDataset(Paths(root=roots["jax"]).images("mini"), resize=(32, 32))
    assert ds.filenames == jds.filenames == ["0.jpg", "1.jpg", "2.jpg", "3.jpg"]
    np.testing.assert_array_equal(ds[2][0], jds[2][0])
    with pytest.raises(ValueError, match="resize"):
        next(ImageFolderDataset(ds.directory).batches(2))

    files = tree(roots["port"])
    assert files == tree(roots["jax"])
    paths = Paths(root=roots["port"])
    for rel in files:
        got, want = (os.path.join(roots[s], rel) for s in ("port", "jax"))
        if "cnn_ResNet50_avg_pool" in rel or rel.endswith("cnn_features_ResNet50_avg_pool.npy"):
            np.testing.assert_allclose(np.load(got), np.load(want), **TOL, err_msg=rel)
        elif rel.endswith(".csv"):
            g, w = pd.read_csv(got), pd.read_csv(want)
            assert list(g.columns) == ["ImageID", "ClassStr", "ClassNum", "Prob"]
            for col in ("ImageID", "ClassStr", "ClassNum"):
                assert g[col].tolist() == w[col].tolist(), col
            np.testing.assert_allclose(g.Prob, w.Prob, rtol=1e-5)
        elif not rel.endswith(".jpg") and not rel.endswith(".txt"):
            with open(got, "rb") as a, open(want, "rb") as b:
                assert a.read() == b.read(), rel  # histograms, colors, tiffs, one-hots
    assert np.load(paths.cnn_features("mini", "ResNet50", "avg_pool")).shape == (4, 2048)
    assert np.load(paths.hist_color_features("mini")).shape == (4, 512)
    assert np.load(paths.class_features("mini")).shape[0] == 4
    assert os.path.exists(os.path.join(paths.edges_dir("mini"), "0.tiff"))


def test_texture_grams():
    rng = np.random.default_rng(0)
    maps = [rng.random((3, 8, 8, 16)).astype(np.float32),
            rng.random((3, 4, 4, 32)).astype(np.float32)]
    out = PE.extract_texture_grams(maps, resize_gram=(8, 8))
    assert out.shape == (3, 2 * 64)
    np.testing.assert_allclose(out, JE.extract_texture_grams(maps, resize_gram=(8, 8)),
                               rtol=1e-4, atol=1e-6)
    # gram of layer 0 for sample 0 matches the direct computation
    import cv2

    f = maps[0][0].reshape(-1, 16)
    want = cv2.resize((f.T @ f) / f.size, dsize=(8, 8), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(out[0, :64], want.flatten(), rtol=1e-4, atol=1e-6)
    # a tensor map computes where it lies
    np.testing.assert_allclose(
        PE.extract_texture_grams([torch.from_numpy(m) for m in maps], resize_gram=(8, 8)),
        out, rtol=1e-6, atol=0)


def test_resnet152_shapes():
    """test_vision.py::test_resnet152_shapes at 32x32, B = 2: the
    extractor over JAX's ResNet-152 init carried across, against JAX's
    network run eagerly."""
    net = JB.ResNet(JB.RESNET152_BLOCKS)
    params = net.init(jax.random.PRNGKey(0))
    ex = PE.CnnFeatureExtractor(output_layer="avg_pool", model_name="ResNet152",
                                imagenet=False, params=np_params(params), device="cpu")
    imgs = np.random.default_rng(0).integers(0, 255, (2, 32, 32, 3), dtype=np.uint8)
    feats = ex.extract_feature(imgs)
    assert feats.shape == (2, 2048)
    x = JE.preprocess(imgs)
    np.testing.assert_allclose(feats, np.asarray(net.apply(params, x)), **TOL)
    out = ex.classify(imgs, ["0.jpg", "1.jpg"])
    assert len(out) == 2
    assert {"ImageID", "ClassStr", "ClassNum", "Prob"} <= set(out[0])
    logits = np.asarray(net.apply(params, x, with_head=True))
    assert [r["ClassNum"] for r in out] == list(logits.argmax(axis=1))
    assert [r["ImageID"] for r in out] == ["0", "1"]
    want = [float(jax.nn.softmax(row)[c]) for row, c in zip(logits, logits.argmax(axis=1))]
    np.testing.assert_allclose([r["Prob"] for r in out], want, rtol=1e-5)


@pytest.mark.parametrize("blocks,name", [
    ((3, 4, 6, 3), "resnet50"),
    ((3, 8, 36, 3), "resnet152"),
])
def test_resnet_torch_numerical_parity(blocks, name):
    sd = _torch_resnet_sd(blocks, seed=3)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        spatial_t, pooled_t, logits_t = _torch_resnet_forward(sd, x, blocks)
    loader = {"resnet50": PB.load_torch_resnet50_state_dict,
              "resnet152": PB.load_torch_resnet152_state_dict}[name]
    port = loader(PB.ResNet(blocks, device="cpu"), sd)  # torch tensors load as they are
    jloader = {"resnet50": JB.load_torch_resnet50_state_dict,
               "resnet152": JB.load_torch_resnet152_state_dict}[name]
    net = JB.ResNet(blocks)
    params = jloader(net, _np_sd(sd))
    x_j = np.transpose(x.numpy(), (0, 2, 3, 1))  # NCHW -> NHWC
    pooled = run(port.apply, x_j)
    logits = run(lambda t: port.apply(t, with_head=True), x_j)
    spatial = run(port.spatial_features, x_j)
    np.testing.assert_allclose(pooled, pooled_t.numpy(), **TOL)
    np.testing.assert_allclose(logits, logits_t.numpy(), **TOL)
    np.testing.assert_allclose(spatial, np.transpose(spatial_t.numpy(), (0, 2, 3, 1)), **TOL)
    # and JAX's pooled features, themselves held against the same
    # reference in its test (the map and logits against JAX's own in
    # test_resnet50_shapes: two f32 routes through 152 layers each within
    # the tolerance of the reference may be twice that apart)
    np.testing.assert_allclose(pooled, np.asarray(net.apply(params, x_j)), **TOL)


def test_resnet_importer_depth_check():
    sd = _np_sd(_torch_resnet_sd((3, 4, 6, 3), seed=0))
    for loader in (PB.load_torch_resnet152_state_dict, JB.load_torch_resnet152_state_dict):
        Net = PB.ResNet if loader is PB.load_torch_resnet152_state_dict else JB.ResNet
        kw = {"device": "cpu"} if Net is PB.ResNet else {}
        with pytest.raises(ValueError, match="blocks"):
            loader(Net((3, 4, 6, 3), **kw), sd)
        with pytest.raises(KeyError, match="resnet152"):
            loader(Net((3, 8, 36, 3), **kw), sd)


def test_vgg19_torch_numerical_parity():
    net = JB.VGG19(input_hw=(64, 64))
    sd = _torch_vgg19_sd(net.flat_dim, seed=5)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        want = dict(zip(("fc1", "fc2", "predictions"), _torch_vgg19_forward(sd, x)))
    port = PB.load_torch_vgg19_state_dict(PB.VGG19(input_hw=(64, 64), device="cpu"), sd)
    params = JB.load_torch_vgg19_state_dict(net, _np_sd(sd))
    x_j = np.transpose(x.numpy(), (0, 2, 3, 1))
    for layer, w in want.items():
        got = run(lambda t: port.apply(t, output_layer=layer), x_j)
        np.testing.assert_allclose(got, w.numpy(), **TOL, err_msg=layer)
        np.testing.assert_allclose(got, np.asarray(net.apply(params, x_j, output_layer=layer)),
                                   **TOL, err_msg=layer)


def test_vgg19_importer_flat_dim_mismatch():
    sd = _np_sd(_torch_vgg19_sd(25088, seed=0))  # 224x224-layout classifier
    with pytest.raises(ValueError, match="flat dim"):
        PB.load_torch_vgg19_state_dict(PB.VGG19(input_hw=(64, 64), device="cpu"), sd)
    with pytest.raises(ValueError, match="flat dim"):
        JB.load_torch_vgg19_state_dict(JB.VGG19(input_hw=(64, 64)), sd)


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_extractor_torch_weights_file_roundtrip(tmp_path, suffix):
    """CnnFeatureExtractor(torch_weights=...) through a state-dict file:
    classify + extract_feature match the torch reference and JAX's
    extractor on the same file."""
    net_blocks = (3, 4, 6, 3)
    sd = _torch_resnet_sd(net_blocks, seed=1)
    path = str(tmp_path / f"resnet50{suffix}")
    if suffix == ".npz":
        np.savez(path, **_np_sd(sd))
    else:
        torch.save(sd, path)
    assert sorted(PB.load_state_dict_file(path)) == sorted(sd)
    ex = PE.CnnFeatureExtractor(output_layer="avg_pool", model_name="ResNet50",
                                torch_weights=path, device="cpu")
    jex = JE.CnnFeatureExtractor(output_layer="avg_pool", model_name="ResNet50",
                                 torch_weights=path)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _, pooled_t, logits_t = _torch_resnet_forward(sd, x, net_blocks)
    x_j = np.transpose(x.numpy(), (0, 2, 3, 1)).astype(np.float32)
    feats = ex.extract_feature(x_j)
    np.testing.assert_allclose(feats, pooled_t.numpy(), **TOL)
    np.testing.assert_allclose(feats, jex.extract_feature(x_j), **TOL)
    recs = ex.classify(x_j, ["0.jpg", "1.jpg"])
    assert [r["ClassNum"] for r in recs] == list(logits_t.argmax(dim=1).numpy())
    jrecs = jex.classify(x_j, ["0.jpg", "1.jpg"])
    assert [(r["ImageID"], r["ClassStr"], r["ClassNum"]) for r in recs] == [
        (r["ImageID"], r["ClassStr"], r["ClassNum"]) for r in jrecs]
    np.testing.assert_allclose([r["Prob"] for r in recs], [r["Prob"] for r in jrecs], rtol=1e-5)


def test_extractor_refuses_other_models():
    with pytest.raises(NotImplementedError, match="has not been added yet"):
        PE.CnnFeatureExtractor(model_name="AlexNet", device="cpu")


def test_preprocess_matches_jax():
    imgs = np.random.default_rng(4).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(PE.preprocess(imgs), JE.preprocess(imgs))


CLASS_SETS = {
    "three names": ["tench, Tinca tinca", "goldfish", 'say "hi"', "goldfish", "tench, Tinca tinca"],
    "numbers": ["575", "9", "10", "575", "9"],
    "two": ["b", "a", "b", "b"],
    "two numbers": ["10", "9", "10"],
    "one": ["7", "7", "7"],
    "multi-line": ["a\nb", "c", "d\te"],
}


@pytest.mark.parametrize("name", list(CLASS_SETS))
def test_classes_csv_and_one_hots_match_pandas_and_sklearn(tmp_path, name):
    """The classes CSV as the port's CLI writes it (``utils/frames.py``)
    byte-equal to ``pd.DataFrame(records).to_csv``; its class column read
    back typed as ``pd.read_csv`` types it; the one-hots bit-equal to
    ``LabelBinarizer`` plus the JAX CLI's fix-up."""
    from sklearn.preprocessing import LabelBinarizer

    from fashionvisualexpl_tpu_torch.cli.extract_features import label_binarize
    from fashionvisualexpl_tpu_torch.utils import frames

    rng = np.random.default_rng(len(name))
    records = [{"ImageID": str(i), "ClassStr": c, "ClassNum": int(rng.integers(1000)),
                "Prob": float(np.float32(rng.random() ** 9))}
               for i, c in enumerate(CLASS_SETS[name])]
    path = str(tmp_path / "classes.csv")
    frames.write_csv(frames.from_rows(records), path)
    want = io.StringIO()
    pd.DataFrame(records).to_csv(want, index=False)
    assert open(path, newline="").read() == want.getvalue()
    df = pd.read_csv(path)
    col = frames.read_csv(path)["ClassStr"]
    assert col.tolist() == df.ClassStr.tolist()
    onehot = LabelBinarizer().fit_transform(df.ClassStr)
    if onehot.shape[1] == 1:
        onehot = np.eye(2, dtype=np.int64)[onehot[:, 0]]
    got = label_binarize(col)
    assert got.dtype == onehot.dtype and got.shape == onehot.shape
    np.testing.assert_array_equal(got, onehot)
