"""Round metrics (port of the round records of `mastic_tpu/metrics.py`).

Every round, incremental or from the root, produces one `RoundMetrics`
record with

* verdict counters: reports accepted, and rejected attributed to the
  first failing check in protocol order (VIDPF eval proof, then FLP
  weight check, then joint-rand confirmation);
* structural op counters: node evaluations, fixed-key AES blocks,
  Keccak node-proof permutations, derived from the public round
  structure (prefix set, level, instantiation), not sampled from the
  device: the round evaluates exactly the scheduled grid;
* bytes per channel: upload, prep share broadcast, prep messages,
  aggregate shares, from the wire size formulas (`wire.py`).

The fields are the JAX package's, so `as_dict()` has its keys.  The
session, transport and service counters stay 0 until the port has
those layers.  `extra` holds, besides the JAX package's key-setup
counts, the port's own entries: "excluded_invalid" (lanes left out
because the caller's `valid` was False: never sharded correctly, so
not recomputed), "rejected_fallback_by" (the checks the recomputed
reports failed), the scalar splice's time ("splice_ms"), on the
incremental rounds the plan, dispatch and wait times ("phases"), and
"round_wall_ms".  The chunked rounds add the JAX package's "chunks",
"memory" and "pipeline" blocks (`drivers/pipeline.py`), and a run on a
report mesh its "mesh" block (`parallel/mesh.py::mesh_block`); the
JAX package's "artifacts" block has no counterpart (the port compiles
no programs).  Under a mesh every counter is global: each round's
masks are gathered over the ranks before they are counted.
"""

from dataclasses import asdict, dataclass, field

import numpy as np

from . import wire


@dataclass
class RoundMetrics:
    level: int
    frontier_width: int          # number of candidate prefixes
    padded_width: int            # device grid width (incremental) or
    #                              total child-grid nodes (from-root)
    reports_total: int
    accepted: int = 0
    rejected_eval_proof: int = 0
    rejected_weight_check: int = 0
    rejected_joint_rand: int = 0
    rejected_fallback: int = 0   # rejected by the scalar fallback path
    xof_fallbacks: int = 0       # lanes recomputed via the scalar path
    # session fault-tolerance counters (party layer):
    timeouts: int = 0
    retries: int = 0
    quarantined: int = 0
    respawns: int = 0
    # transport-recovery counters (network layer):
    reconnects: int = 0
    replayed_frames: int = 0
    # structural op counts, summed over both aggregators:
    node_evals: int = 0
    aes_extend_blocks: int = 0
    aes_convert_blocks: int = 0
    keccak_node_proofs: int = 0
    # bytes per channel for this round:
    bytes_upload: int = 0        # client -> one aggregator (x2 parties)
    bytes_prep_shares: int = 0   # aggregator <-> aggregator
    bytes_prep_msgs: int = 0     # leader -> helper
    bytes_agg_shares: int = 0    # aggregators -> collector
    extra: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return asdict(self)


def attribute_rejections(metrics: RoundMetrics, eval_proof_ok,
                         weight_check_ok=None, joint_rand_ok=None,
                         device_ok=None) -> np.ndarray:
    """Fill the verdict counters from per-report check masks; returns
    the combined accept mask.  Attribution is to the first failing
    check in protocol order.  Lanes where `device_ok` is False carried
    garbage through the device checks; they are left out here and
    attributed by the caller."""
    eval_proof_ok = np.asarray(eval_proof_ok, bool)
    valid = (np.ones_like(eval_proof_ok) if device_ok is None
             else np.asarray(device_ok, bool))
    accept = eval_proof_ok & valid
    metrics.rejected_eval_proof = int((valid & ~eval_proof_ok).sum())
    if weight_check_ok is not None:
        weight_check_ok = np.asarray(weight_check_ok, bool)
        metrics.rejected_weight_check = int(
            (valid & eval_proof_ok & ~weight_check_ok).sum())
        accept &= weight_check_ok
    if joint_rand_ok is not None:
        joint_rand_ok = np.asarray(joint_rand_ok, bool)
        metrics.rejected_joint_rand = int((accept & ~joint_rand_ok).sum())
        accept &= joint_rand_ok
    metrics.accepted = int(accept.sum())
    return accept


def count_round_ops(metrics: RoundMetrics, mastic, num_reports: int,
                    nodes_evaluated: int,
                    include_key_setup: bool = False) -> None:
    """Structural op counts for one aggregator's round, doubled for the
    pair: per node eval 1 extend block, 1 + ceil(VALUE_LEN * elem / 16)
    convert blocks and 1 node-proof permutation.  `nodes_evaluated` is
    the per-report child-node count the round materialises."""
    payload_bytes = mastic.value_len * mastic.field.ENCODED_SIZE
    convert_blocks = 1 + (payload_bytes + 15) // 16
    per_agg = num_reports * nodes_evaluated
    metrics.node_evals = 2 * per_agg
    # extend: one 2-block AES call per parent = 1 block per child.
    metrics.aes_extend_blocks = 2 * per_agg
    metrics.aes_convert_blocks = 2 * per_agg * convert_blocks
    metrics.keccak_node_proofs = 2 * per_agg
    if include_key_setup:
        metrics.extra["aes_key_schedules"] = 4 * num_reports
        metrics.extra["fixed_key_derivations"] = 4 * num_reports


def count_round_bytes(metrics: RoundMetrics, mastic, agg_param,
                      num_reports: int) -> None:
    use_jr = mastic.valid.JOINT_RAND_LEN > 0
    (_level, _prefixes, do_weight_check) = agg_param
    # Uploads are paid once per collection, on the round the reports
    # enter it, which the drivers mark with the weight check.
    if do_weight_check:
        metrics.bytes_upload = num_reports * upload_bytes(mastic)
    metrics.bytes_prep_shares = \
        2 * num_reports * wire.prep_share_size(mastic, agg_param)
    if do_weight_check and use_jr:
        metrics.bytes_prep_msgs = num_reports * wire.SEED_SIZE
    metrics.bytes_agg_shares = 2 * wire.agg_share_size(mastic, agg_param)


def upload_bytes(mastic) -> int:
    """Per-report upload to one aggregator pair: the public share (the
    packed ctrl bits, then per level a seed, a proof and a payload
    correction word) and both input shares."""
    bits = mastic.bits
    elem = mastic.field.ENCODED_SIZE
    public = (2 * bits + 7) // 8 + bits * (16 + 32) \
        + bits * mastic.value_len * elem
    return public + wire.input_share_size(mastic, 0) \
        + wire.input_share_size(mastic, 1)
