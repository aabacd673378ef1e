"""plan.build_s: host wall seconds of the one ``plan()`` call in set-up,
the paper's distribution time (``repro_torch.core.plan``,
``core/distribution.py``, ``core/metrics.py``,
``distributed/partition.py``). Set-up holds it, so it moves ``setup_s``.
Nothing to read for an entry that builds no plan."""


def read(ctx):
    return ctx.setup.get("plan_s")
