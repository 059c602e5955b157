"""`repro_torch.campaigns` — declarative multi-scenario experiments.

The paper's evaluation is comparative (MILP vs heuristics vs metaheuristics
across workflow families and scales); this package is the API for "run this
grid and compare", the reference's spec format and results, run by the port:

* :class:`Campaign` (:mod:`~repro_torch.campaigns.spec`) — a
  JSON-round-trippable grid spec: named/zipped axes × per-axis defaults ×
  include/exclude/skip filters, expanding deterministically into
  :class:`CampaignCell`s that compile to
  :class:`~repro_torch.core.api.Scenario`s;
* runners (:mod:`~repro_torch.campaigns.runner`) — ``inline``
  (fingerprint-deduped, shape-bucket-batched registry solves: a batched GA
  group is one ``ga_sweep``, one makespan launch a generation) and
  ``service`` (the grid streamed through the event-driven scheduler as an
  arrival trace), pluggable via :func:`register_runner`;
* :class:`ResultSet` (:mod:`~repro_torch.campaigns.results`) — typed columnar
  results with JSON/CSV round-trip, ``group_by``/``aggregate``, and the
  Table IX ``deviation_vs("milp")`` optimality-gap report;
* built-ins (:mod:`~repro_torch.campaigns.builtin`) — the reference's lanes
  (``smoke`` / ``table9`` / ``service`` / ``chaos`` / ``engine`` /
  ``topology`` / ``cycling``) as named campaigns with exporters of the reference's
  ``BENCH_*.json`` payloads (pass them an ``out_path``).

Every entry point takes ``device`` (default ``"cuda"``).

Quickstart::

    from repro_torch.campaigns import builtin_campaign, run_campaign

    rs = run_campaign(builtin_campaign("table9"))      # device="cpu": no card
    print(rs.deviation_report("milp").to_csv())

or from the CLI::

    python -m repro_torch campaign expand examples/campaign_table9.json
    python -m repro_torch campaign run examples/campaign_table9.json --vs milp
"""

from repro_torch.campaigns.builtin import (
    BUILTIN_CAMPAIGNS,
    CampaignRun,
    builtin_campaign,
    engine_campaign,
    resolve_campaign,
    run_named_campaign,
    service_campaign,
    smoke_campaign,
    table9_campaign,
)
from repro_torch.campaigns.results import Column, ResultSet
from repro_torch.campaigns.runner import (
    RUNNERS,
    effective_options,
    register_runner,
    run_campaign,
    solve_identity,
)
from repro_torch.campaigns.spec import (
    WORKLOAD_FAMILIES,
    Axis,
    Campaign,
    CampaignCell,
    SkipRule,
    campaign_from_json,
    cell_scenario,
    cell_system,
    cell_workload,
    load_campaign,
    matches,
)

__all__ = [
    "BUILTIN_CAMPAIGNS",
    "Axis",
    "Campaign",
    "CampaignCell",
    "CampaignRun",
    "Column",
    "RUNNERS",
    "ResultSet",
    "SkipRule",
    "WORKLOAD_FAMILIES",
    "builtin_campaign",
    "campaign_from_json",
    "cell_scenario",
    "cell_system",
    "cell_workload",
    "effective_options",
    "engine_campaign",
    "load_campaign",
    "matches",
    "register_runner",
    "resolve_campaign",
    "run_campaign",
    "run_named_campaign",
    "service_campaign",
    "smoke_campaign",
    "solve_identity",
    "table9_campaign",
]
