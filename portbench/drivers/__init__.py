"""The loops that serve a traffic mix, one module per `kind`."""

import numpy as np


def check_sample(seed: int, designs: list, groups: list, sizes: list, k: int) -> list:
    """Indices of the items to check: the largest by `sizes`; then, in an
    order drawn from the seed, one item of every group (such as a request's
    bucket pair) not yet covered; then others until `k`, at most one for
    each design index."""
    largest = max(range(len(sizes)), key=lambda i: sizes[i])
    order = np.random.default_rng([seed, 1]).permutation(len(sizes)).tolist()
    pick, seen, covered = [largest], {designs[largest]}, {groups[largest]}
    for i in order:
        if groups[i] not in covered and designs[i] not in seen:
            pick.append(i)
            seen.add(designs[i])
            covered.add(groups[i])
    for i in order:
        if len(pick) >= k:
            break
        if designs[i] not in seen:
            seen.add(designs[i])
            pick.append(i)
    return pick
