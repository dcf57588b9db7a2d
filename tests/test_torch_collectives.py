"""The collectives' ``meta`` branch (the dry run's): under a fake (2, 2)
group each collective returns a meta result of the right shape, moves
and stages nothing (``TRAFFIC`` unchanged) and charges the JAX package's
wire formula into the active counter; CPU tensors under gloo (two ranks)
still move and count as before.  No JAX here: the rank bodies run in
processes forked from a server that imports this module."""
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.launch import dryrun as TD
from repro_torch.launch import op_analysis as TO
from repro_torch.launch.mesh import axis_group, make_mesh, run_ranks


@pytest.fixture
def fake_2x2():
    TD.join_fake_group(4)
    yield make_mesh((2, 2), ("data", "model"), device="cpu")
    dist.destroy_process_group()


def test_meta_collectives_charge_and_move_nothing(fake_2x2):
    group = axis_group(fake_2x2, "model")           # 2 ranks
    x = torch.empty(6, 10, dtype=torch.bfloat16, device="meta")
    y = torch.empty(3, 4, device="meta")
    owned = torch.empty(6, 10, dtype=torch.bool, device="meta")
    before = C.TRAFFIC.as_dict()

    def program():
        out = {"sum": C.all_reduce_sum(y, group),
               "reduce": C.all_reduce(x, group),
               "masked": C.masked_all_reduce(x, owned, group),
               "gather0": C.all_gather(y, 0, group),
               "gather1": C.all_gather(x, 1, None)}    # the world: 4
        pend = C.start([(1, y)], [(1, (3, 4))], torch.float32, "meta",
                       group)
        out["recv"] = pend.wait()
        return out
    out, cost = TO.count(program)
    assert C.TRAFFIC.as_dict() == before
    assert out["sum"] is y
    assert tuple(out["reduce"].shape) == (6, 10)
    assert out["reduce"].dtype == torch.bfloat16
    assert tuple(out["masked"].shape) == (6, 10)
    assert tuple(out["gather0"].shape) == (6, 4)
    assert tuple(out["gather1"].shape) == (6, 40)
    assert [tuple(t.shape) for t in out["recv"]] == [(3, 4)]
    assert all(t.device.type == "meta" for t in
               [*out["recv"]] + [v for k, v in out.items() if k != "recv"])
    # the reference's rule: all-reduce 2 (n-1)/n of its bytes (bf16 is
    # summed in f32: its f32 copy's), all-gather (n-1) x the rank's piece,
    # a permute once
    ar = 12 * 4 + 2 * 60 * 4
    ag = 12 * 4 * 1 + 60 * 2 * 3
    assert cost.coll_bytes == 12 * 4 + 2 * 60 * 4 + 12 * 4 + 60 * 2 + 12 * 4
    assert cost.coll_by_type["all-reduce"] == pytest.approx(ar * 2 * 1 / 2)
    assert cost.coll_by_type["all-gather"] == ag
    assert cost.coll_by_type["collective-permute"] == 12 * 4
    assert cost.coll_wire_bytes == pytest.approx(ar + ag + 12 * 4)
    assert dict(cost.coll_count) == {"all-reduce": 3, "all-gather": 2,
                                     "collective-permute": 1}


def cpu_traffic(rank, world):
    """A rank's all-reduce, all-gather and exchange on CPU tensors."""
    C.TRAFFIC.reset()
    x = torch.full((3, 4), float(rank + 1))
    s = C.all_reduce(x)
    g = C.all_gather(x, 0)
    got = C.start([(1 - rank, x)], [(1 - rank, (3, 4))], torch.float32,
                  "cpu").wait()
    return (C.TRAFFIC.as_dict(), s.tolist(), g.shape[0],
            float(got[0][0, 0]))


def test_cpu_collectives_under_gloo_move_and_count_as_before():
    for rank, (traffic, s, rows, got) in enumerate(
            run_ranks(cpu_traffic, 2, timeout=120)):
        assert s == [[3.0] * 4] * 3 and rows == 6 and got == 2.0 - rank
        assert traffic["staged"] == 0 and traffic["calls"] == 3
        assert traffic["sent"] == 48 * 3
        assert traffic["received"] == 48 + 48 + 48
