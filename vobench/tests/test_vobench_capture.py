"""``spans.Capture``: of the passes a window runs it keeps the judged one
whole, drawn uniformly from the seed, and every pass's tally; the device
holds at most two passes' outputs at a time, however many passes run."""

import weakref
from collections import Counter

import torch

from vobench.spans import Capture


class Out:
    """A wrapped function's result: a flag tensor and a payload whose
    lifetime the test follows."""

    def __init__(self, flags: torch.Tensor):
        self.flags = flags
        self.payload = torch.zeros(4)


def run(seed: int, n: int, flags=None, alive=None) -> Capture:
    cap = Capture(seed)
    solve = cap.wrap("res", lambda r: (r.payload, r.flags), lambda r: (r.flags,))(Out)
    for i in range(n):
        cap.start_pass()
        out = solve(flags[i] if flags is not None else torch.ones(3, dtype=torch.bool))
        if alive is not None:
            alive.append(weakref.ref(out.payload))
            del out  # no cycles: the reference count frees what nothing keeps
            assert sum(r() is not None for r in alive) <= 2
    return cap


def test_the_judged_pass_is_uniform_over_the_passes():
    n, trials = 5, 4000
    picks = Counter(run(seed, n).judged_index for seed in range(trials))
    assert set(picks) == set(range(n))
    for count in picks.values():  # each share 0.2; 5 binomial sigmas is 0.032
        assert abs(count / trials - 1 / n) < 0.035


def test_the_same_seed_picks_the_same_pass():
    for seed in (0, 7, 2**31 + 5):
        assert run(seed, 9).judged_index == run(seed, 9).judged_index
    assert len({run(seed, 9).judged_index for seed in range(40)}) > 1


def test_failed_counts_the_flags_of_every_pass():
    gen = torch.Generator().manual_seed(3)
    flags = [torch.rand(6, generator=gen) < 0.7 for _ in range(11)]
    cap = run(11, 11, flags)
    assert sum(int((~c).sum()) for c in cap.tallied("res")) == sum(int((~f).sum()) for f in flags)
    judged = cap.judged["res"][0][1]
    assert torch.equal(judged, flags[cap.judged_index])
    for kept, planted in zip(cap.tallied("res"), flags):
        assert kept.untyped_storage().data_ptr() != planted.untyped_storage().data_ptr()


def test_at_most_two_passes_are_alive():
    alive = []
    cap = run(5, 60, alive=alive)
    assert sum(r() is not None for r in alive) == 1
    assert alive[cap.judged_index]() is not None
    assert cap.n == len(cap.tallies) == 60


def test_nothing_is_kept_before_a_pass_starts_or_while_off():
    cap = Capture(1)
    solve = cap.wrap("res", None, lambda r: (r.flags,))(Out)
    solve(torch.ones(2, dtype=torch.bool))  # a warm-up pass: no pass started
    cap.on = False
    cap.start_pass()
    solve(torch.ones(2, dtype=torch.bool))
    assert cap.judged == {} and cap.tallied("res") == []
