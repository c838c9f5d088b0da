"""The port's dry-run profiler (``tools/collective_profile_torch.py``) on
a reduced cell: granite-moe-1b-a400m's reduced step, train 16 x 8 over 2
microbatches, on a fake (2, 2) group of 4 ranks (a subprocess: a fake
group is its process's default group).  The ranked entries' link bytes,
each a node's times its run count, sum to the step's
``collective_link_bytes_per_device`` (``total_link_bytes``), their counts
to its collective count; the microbatch body's collectives count twice;
every entry names the model code it came from.
"""
from test_torch_dryrun import finish, run_sub

PROFILE = """
import json, sys
sys.path.insert(0, "tools")
from collective_profile_torch import rank_cell
from repro_torch.configs import ShapeSuite, get_config
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import production_rules
cfg = get_config("granite-moe-1b-a400m").reduced()
ranked, stats = rank_cell(cfg, ShapeSuite("t", 16, 8, "train"), make_fake_mesh((2, 2)),
                          production_rules(), accum=2)
print(json.dumps({"entries": ranked, "link_bytes": stats.collectives.total_link_bytes,
                  "count": stats.collectives.total_count}))
"""


def test_profiler_ranks_every_collective_of_a_reduced_cell():
    r = finish(run_sub(PROFILE))
    ranked = r["entries"]
    assert ranked and sum(e["link_bytes"] for e in ranked) == r["link_bytes"] > 0
    assert sum(e["count"] for e in ranked) == r["count"]
    assert [e["link_bytes"] for e in ranked] == sorted((e["link_bytes"] for e in ranked),
                                                       reverse=True)
    assert {e["count"] for e in ranked} == {1, 2}  # the microbatch body's run twice
    assert all(e["group"] == 2 and ".py:" in e["origin"] for e in ranked)
