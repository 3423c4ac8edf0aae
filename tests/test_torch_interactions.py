"""Port data layer vs the JAX package: every array bit-equal."""

import numpy as np
import pytest

from fashionvisualexpl_tpu.core.config import Paths as JPaths
from fashionvisualexpl_tpu.core.config import TrainConfig as JTrainConfig
from fashionvisualexpl_tpu.data import interactions as J
from fashionvisualexpl_tpu.data.synthetic_dataset import write_reference_layout
from fashionvisualexpl_tpu_torch.core.config import Paths, TrainConfig
from fashionvisualexpl_tpu_torch.data import interactions as T


def _assert_same(a, b):
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    assert a.training_list == b.training_list
    assert a.validation_list == b.validation_list
    assert a.test_list == b.test_list
    for name in ("train_pairs", "padded_pos", "pos_counts"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize(
    "U,I,per_user,seed,validation",
    [(30, 40, 8, 0, True), (17, 200, 5, 3, True), (9, 25, 2, 1, False),
     (12, 12, 12, 5, True)],
)
def test_synthetic_interactions_bit_equal(U, I, per_user, seed, validation):
    a = J.synthetic_interactions(U, I, per_user, seed=seed, validation=validation)
    b = T.synthetic_interactions(U, I, per_user, seed=seed, validation=validation)
    _assert_same(a, b)


def test_pad_helpers_bit_equal():
    rng = np.random.default_rng(0)
    lists = [
        rng.choice(50, size=int(rng.integers(0, 9)), replace=False).tolist()
        for _ in range(25)
    ]
    for width in (None, 12):
        for pad_value in (0, -1):
            x, y = J.pad_lists(lists, pad_value, width), T.pad_lists(lists, pad_value, width)
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
            assert x[0].dtype == y[0].dtype == np.int32
        x, y = J.pad_sorted_positives(lists, 50, width), T.pad_sorted_positives(lists, 50, width)
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    # truncation when a row is wider than the width
    x, y = J.pad_lists(lists, 0, 3), T.pad_lists(lists, 0, 3)
    np.testing.assert_array_equal(x[0], y[0])
    with pytest.raises(ValueError):
        T.pad_sorted_positives([[1, 2, 3]], 5, width=2)


def test_duplicate_train_rows_deduped_with_warning():
    def make(cls):
        return cls(num_users=2, num_items=5, training_list=[[1, 1, 2], [3, 4, 3]],
                   validation_list=[[], []], test_list=[[4], [0]])

    with pytest.warns(UserWarning, match="duplicate"):
        a = make(J.Interactions)
    with pytest.warns(UserWarning, match="duplicate"):
        b = make(T.Interactions)
    assert b.training_list == [[1, 2], [3, 4]]
    assert b.num_train == 4
    _assert_same(a, b)


@pytest.mark.parametrize("validation", [True, False])
def test_load_reference_layout_bit_equal(tmp_path, validation):
    data = J.synthetic_interactions(20, 30, interactions_per_user=6, seed=2,
                                    validation=validation)
    write_reference_layout(JPaths(root=str(tmp_path)), "ds", data,
                           cnn_dim=8, with_images=False)
    a = J.Interactions.load(JTrainConfig(dataset="ds", paths=JPaths(root=str(tmp_path))))
    b = T.Interactions.load(TrainConfig(dataset="ds", paths=Paths(root=str(tmp_path))))
    _assert_same(a, b)
    _assert_same(data, b)
    assert b.has_validation == validation
    assert b.steps_per_epoch(7) == a.steps_per_epoch(7)


def test_split_parsers_agree(tmp_path):
    path = tmp_path / "split.tsv"
    path.write_text("0\t3\t0\t1.0\n\n2\t1\n1\t7\t5\t2.0\n")
    assert T.read_split_tsv(str(path)) == J.read_split_tsv(str(path), use_native=False)
    assert T.pairs_to_user_lists([(0, 3), (2, 1), (0, 1)], 3) == [[3, 1], [], [1]]
