"""The port's pipeline core against the JAX package: ``parse_launch`` of the
serve and client descriptions, caps negotiation, ``structure_key`` and the
serve-tick cache key."""
import numpy as np
import pytest
import torch

from repro.core import parse_caps as jax_parse_caps
from repro.core import parse_launch as jax_parse_launch
from repro.launch import model_serve as jax_ms
from repro_torch.core import (Caps, CapsError, StreamBuffer, TensorSpec,
                              executable_cache_info, parse_caps,
                              parse_launch, stack_buffers, structure_key,
                              unstack_buffers)
from repro_torch.core.buffers import tree_flatten, tree_unflatten
from repro_torch.launch import model_serve as ms

torch.set_num_threads(2)


def _topology(pipe):
    """Element classes, wiring and negotiated caps, with auto-generated
    element names (a process-wide counter) replaced by their order."""
    pipe.realize()
    idx = {e.name: i for i, e in enumerate(pipe._order)}
    elems = [(type(e).__name__, e.factory_name) for e in pipe._order]
    links = [(idx[l.src.name], l.src_pad, idx[l.dst.name], l.dst_pad)
             for l in pipe.links]
    caps = [[c.describe() for c in e.out_caps] for e in pipe._order]
    return elems, links, caps


@pytest.mark.parametrize("which", ["serve", "client"])
def test_serve_and_client_descriptions_parse_like_jax(which):
    if which == "serve":
        ours = ms.serve_pipeline(slots=4, max_seq=16)
        theirs = jax_ms.serve_pipeline(slots=4, max_seq=16)
    else:
        ours = ms.client_pipeline(prompts="1,2;3", gens="4;2")
        theirs = jax_ms.client_pipeline(prompts="1,2;3", gens="4;2")
    assert _topology(ours) == _topology(theirs)


@pytest.mark.parametrize("caps", [
    "video/x-raw,width=300,height=300,format=RGB",
    "other/tensors,num_tensors=2,dimensions=4:20:1:1,20:1:1:1,"
    "types=float32,int32",
    "other/tensor,dimensions=3:224:224,types=uint8,format=flexible",
    "other/flexbuf",
])
def test_parse_caps_matches_jax(caps):
    assert parse_caps(caps).describe() == jax_parse_caps(caps).describe()


def test_negotiation_intersects_and_rejects():
    pipe = parse_launch("testsrc width=8 height=6 ! "
                        "video/x-raw,width=8,height=6 ! appsink name=out")
    pipe.realize()
    assert pipe.elements["out"].in_caps[0].tensors[0].shape == (6, 8, 3)
    bad = parse_launch("testsrc width=8 height=6 ! "
                       "video/x-raw,width=9,height=6 ! appsink")
    with pytest.raises(CapsError):
        bad.realize()


def test_videoscale_takes_its_target_from_the_capsfilter():
    src = ("testsrc width=16 height=12 ! videoscale ! "
           "video/x-raw,width=8,height=4 ! appsink name=out")
    ours, theirs = parse_launch(src), jax_parse_launch(src)
    assert _topology(ours) == _topology(theirs)


def test_testsrc_frames_match_jax():
    ours = parse_launch("testsrc width=5 height=3 ! appsink name=out")
    theirs = jax_parse_launch("testsrc width=5 height=3 ! appsink name=out")
    st = ours.init_state("cpu")
    jst = theirs.init_state()
    for _ in range(3):
        out, st = ours.step({}, st)
        jout, jst = theirs.step({}, jst)
        np.testing.assert_array_equal(out["out"].tensor.numpy(),
                                      np.asarray(jout["out"].tensor))


def test_structure_key_groups_like_shapes_and_splits_the_rest():
    a = StreamBuffer(tensors=(torch.zeros(3, dtype=torch.int32),),
                     meta={"gen": 4})
    b = StreamBuffer(tensors=(torch.ones(3, dtype=torch.int32),),
                     meta={"gen": 4})
    assert structure_key(a) == structure_key(b)
    for other in (StreamBuffer(tensors=(torch.zeros(4, dtype=torch.int32),),
                               meta={"gen": 4}),
                  StreamBuffer(tensors=(torch.zeros(3),), meta={"gen": 4}),
                  StreamBuffer(tensors=(torch.zeros(3, dtype=torch.int32),),
                               meta={"gen": 5})):
        assert structure_key(other) != structure_key(a)
    hash(structure_key(a))


def test_flatten_round_trips_and_stacks():
    tree = {"b": [torch.arange(3), None], "a": (torch.zeros(2, 2),),
            "buf": StreamBuffer(tensors=(torch.ones(2),), meta={"k": 1})}
    leaves, td = tree_flatten(tree)
    back = tree_unflatten(td, leaves)
    assert structure_key(back) == structure_key(tree)
    assert back["buf"].meta == {"k": 1} and back["b"][1] is None
    frames = [StreamBuffer(tensors=(torch.full((2,), float(i)),))
              for i in range(3)]
    stacked = stack_buffers(frames)
    assert tuple(stacked.tensors[0].shape) == (3, 2)
    for i, f in enumerate(unstack_buffers(stacked)):
        assert torch.equal(f.tensors[0], frames[i].tensors[0])
    with pytest.raises(ValueError):
        stack_buffers([frames[0], StreamBuffer(tensors=(torch.ones(3),
                                                        torch.ones(1)))])


def test_serve_tick_cache_key_follows_the_state_structure():
    def plan_and_state(slots):
        pipe = ms.serve_pipeline(slots=slots, max_seq=16)
        pipe.realize()
        return pipe.plan, pipe.init_state("cpu")
    p1, s1 = plan_and_state(4)
    p1b, s1b = plan_and_state(4)
    p2, s2 = plan_and_state(2)
    f1 = p1.compiled_serve_tick(s1)
    n = executable_cache_info()["executables"]
    # a structurally identical re-build shares the callable, builds nothing
    assert p1b.compiled_serve_tick(s1b) is f1
    assert executable_cache_info()["executables"] == n
    # another slot count is another state structure
    assert p2.compiled_serve_tick(s2) is not f1


def test_caps_spec_maps_tags_to_torch_dtypes():
    from repro_torch.core.formats import tag_to_dtype, dtype_to_tag
    for name in ("int32", "float32", "bfloat16", "uint8"):
        assert tag_to_dtype(dtype_to_tag(name)) == getattr(torch, name)
        assert dtype_to_tag(getattr(torch, name)) == dtype_to_tag(name)
    assert TensorSpec((2, 3), "bfloat16").nbytes == 12
    assert Caps.ANY.intersect(Caps(media="video/x-raw")).media == \
        "video/x-raw"
