"""Dispatch: DP kernel launches (the wrappers' ``launches`` counters of
align_tiles, align_pairs and align_grid) per job, averaged over the pool's
sets, each set counted by the mean of its jobs: the same seed gives the same
count whatever number of jobs the window held."""


def read(r):
    per_set: dict = {}
    for j in r.jobs:
        per_set.setdefault(j.set_index, []).append(sum(j.launches.values()))
    if not per_set:
        return None
    means = [sum(v) / len(v) for v in per_set.values()]
    return sum(means) / len(means)
