"""The port's conversation templates and LeopardProcessor against the JAX
package's: identical prompt strings, and identical ids, loss weights and
pixels (exact equality) on FakeTokenizer and seeded PIL images, in both
layouts and both pixel dtypes, guards included."""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from leopard_tpu import config as cfgs
from leopard_tpu.data import conversation as jconv
from leopard_tpu.data.processor import LeopardProcessor as JProcessor
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.data import conversation as tconv
from leopard_tpu_torch.data.processor import LeopardProcessor as TProcessor
from tests.test_chat import FakeTokenizer

TOK = FakeTokenizer()


def noise_image(rng, w, h):
    return Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))


def images(seed, sizes):
    rng = np.random.RandomState(seed)
    return [noise_image(rng, w, h) for w, h in sizes]


TURNS = [("user", "<image> and <image>: which one is wider?"), ("assistant", "the first"),
         ("user", "and the second one?"), ("assistant", None)]


@pytest.mark.parametrize("name", sorted(jconv.TEMPLATES))
def test_conversation_templates_identical(name):
    assert sorted(tconv.TEMPLATES) == sorted(jconv.TEMPLATES)
    j, t = jconv.get_template(name), tconv.get_template(name)
    assert t.sep_style.name == j.sep_style.name
    assert t.get_prompt() == j.get_prompt()  # system alone
    for conv in (j, t):
        for role, msg in TURNS:
            conv.append_message(conv.roles[0] if role == "user" else conv.roles[1], msg)
    assert t.get_prompt() == j.get_prompt()
    # copies do not share messages with the registry
    assert tconv.get_template(name).messages == []


@pytest.mark.parametrize("system", ["", "Be brief."])
def test_conversation_system_prompt(system):
    for name in ("llama_2", "llama_3", "mpt"):
        j = dataclasses.replace(jconv.get_template(name), system=system)
        t = dataclasses.replace(tconv.get_template(name), system=system)
        for conv in (j, t):
            conv.append_message(conv.roles[0], "hi")
            conv.append_message(conv.roles[1], "hello")
        assert t.get_prompt() == j.get_prompt()


def _pair(layout, pixel_dtype, **anyres):
    jcfg, tcfg = cfgs.tiny_vlm(), tcfgs.tiny_vlm()
    if anyres:
        jcfg = dataclasses.replace(jcfg, anyres=dataclasses.replace(jcfg.anyres, **anyres))
        tcfg = dataclasses.replace(tcfg, anyres=dataclasses.replace(tcfg.anyres, **anyres))
    return (JProcessor(jcfg, TOK, layout=layout, pixel_dtype=pixel_dtype),
            TProcessor(tcfg, TOK, layout=layout, pixel_dtype=pixel_dtype))


def _same_sample(j, t):
    assert (j is None) == (t is None)
    if j is None:
        return
    for field in ("input_ids", "loss_weights", "pixel_values"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert t.tiles_per_image == j.tiles_per_image
    assert t.seq_len == j.seq_len


# image sizes: one wide and one tall that tile, one that stays a single tile
SIZES = [(150, 60), (40, 170), (30, 30)]


@pytest.mark.parametrize("layout", ["train", "eval"])
@pytest.mark.parametrize("pixel_dtype", ["float32", "uint8"])
def test_process_chat_identical(layout, pixel_dtype):
    jp, tp = _pair(layout, pixel_dtype)
    # placeholders in two user turns; with fewer placeholders than images
    # the missing ones go in front of the first message
    cases = {0: ("no image here", "and now?"), 1: ("<image> what is it?", "sure?"),
             2: ("which is wider?", "sure?"), 3: ("<image> left of <image>?", "and <image>?")}
    for n, (q1, q2) in cases.items():
        msgs = [("user", q1), ("assistant", "a cat"), ("user", q2), ("assistant", "yes")]
        ims = images(n, SIZES[:n])
        _same_sample(jp.process_chat(msgs, ims), tp.process_chat(msgs, ims))


@pytest.mark.parametrize("layout", ["train", "eval"])
@pytest.mark.parametrize("pixel_dtype", ["float32", "uint8"])
def test_process_images_identical(layout, pixel_dtype):
    jp, tp = _pair(layout, pixel_dtype)
    ims = images(7, SIZES)
    for order in (None, "train", "eval"):
        (jpx, jtiles), (tpx, ttiles) = jp.process_images(ims, order), tp.process_images(ims, order)
        assert ttiles == jtiles and tpx.dtype == jpx.dtype
        np.testing.assert_array_equal(tpx, jpx)


@pytest.mark.parametrize("pixel_dtype", ["float32", "uint8"])
def test_process_eval_identical(pixel_dtype):
    jp, tp = _pair("eval", pixel_dtype)
    for n, instruction in ((2, ""), (3, "Answer briefly.")):
        ims = images(n + 10, SIZES[:n])
        (jids, jpx), (tids, tpx) = (p.process_eval("<image> vs <image>: which?", ims, instruction)
                                    for p in (jp, tp))
        assert tids.dtype == jids.dtype
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tpx, jpx)


def test_guard_too_many_images():
    jp, tp = _pair("train", "float32", max_images=2)
    ims = images(3, SIZES)
    msgs = [("user", "<image> hi"), ("assistant", "yo")]
    assert jp.process_chat(msgs, ims) is None and tp.process_chat(msgs, ims) is None
    assert tp.process_chat(msgs, ims[:2]) is not None
    _same_sample(jp.process_chat(msgs, ims[:2]), tp.process_chat(msgs, ims[:2]))


def test_guard_image_token_count():
    """A text character that tokenizes to the image token id makes the
    image-token count disagree with the tiles: both processors refuse."""
    jcfg = dataclasses.replace(cfgs.tiny_vlm(), image_token_id=ord("Z"))
    tcfg = dataclasses.replace(tcfgs.tiny_vlm(), image_token_id=ord("Z"))
    jp, tp = JProcessor(jcfg, TOK), TProcessor(tcfg, TOK)
    ims = images(4, SIZES[:1])
    bad = [("user", "<image> Zebra?"), ("assistant", "yes")]
    good = [("user", "<image> zebra?"), ("assistant", "yes")]
    assert jp.process_chat(bad, ims) is None and tp.process_chat(bad, ims) is None
    assert tp.process_chat(good, ims) is not None
    _same_sample(jp.process_chat(good, ims), tp.process_chat(good, ims))


def test_pixel_dtype_checked():
    with pytest.raises(ValueError):
        TProcessor(tcfgs.tiny_vlm(), TOK, pixel_dtype="float16")
