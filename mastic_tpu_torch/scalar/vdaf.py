"""Copy of `mastic_tpu/vdaf.py`: the abstract VDAF interface and an
in-process protocol runner (draft-irtf-cfrg-vdaf-13 §5).

Multi-party execution without a cluster is function composition: every
party is a pure function over bytes, so the runner calls each party's
functions in protocol order.
"""

from typing import Any, Generic, TypeVar

from .common import gen_rand

Measurement = TypeVar("Measurement")
AggParam = TypeVar("AggParam")
PublicShare = TypeVar("PublicShare")
InputShare = TypeVar("InputShare")
OutShare = TypeVar("OutShare")
AggShare = TypeVar("AggShare")
AggResult = TypeVar("AggResult")
PrepState = TypeVar("PrepState")
PrepShare = TypeVar("PrepShare")
PrepMessage = TypeVar("PrepMessage")


class Vdaf(Generic[Measurement, AggParam, PublicShare, InputShare, OutShare,
                   AggShare, AggResult, PrepState, PrepShare, PrepMessage]):
    """A Verifiable Distributed Aggregation Function."""

    ID: int
    VERIFY_KEY_SIZE: int
    RAND_SIZE: int
    NONCE_SIZE: int
    SHARES: int
    ROUNDS: int

    # Client.
    def shard(self, ctx: bytes, measurement: Measurement, nonce: bytes,
              rand: bytes) -> tuple[PublicShare, list[InputShare]]:
        raise NotImplementedError()

    # Aggregator.
    def is_valid(self, agg_param: AggParam,
                 previous_agg_params: list[AggParam]) -> bool:
        raise NotImplementedError()

    def prep_init(self, verify_key: bytes, ctx: bytes, agg_id: int,
                  agg_param: AggParam, nonce: bytes,
                  public_share: PublicShare, input_share: InputShare) \
            -> tuple[PrepState, PrepShare]:
        raise NotImplementedError()

    def prep_shares_to_prep(self, ctx: bytes, agg_param: AggParam,
                            prep_shares: list[PrepShare]) -> PrepMessage:
        raise NotImplementedError()

    def prep_next(self, ctx: bytes, prep_state: PrepState,
                  prep_msg: PrepMessage) -> OutShare:
        raise NotImplementedError()

    def agg_init(self, agg_param: AggParam) -> AggShare:
        raise NotImplementedError()

    def agg_update(self, agg_param: AggParam, agg_share: AggShare,
                   out_share: OutShare) -> AggShare:
        raise NotImplementedError()

    def merge(self, agg_param: AggParam,
              agg_shares: list[AggShare]) -> AggShare:
        raise NotImplementedError()

    # Collector.
    def unshard(self, agg_param: AggParam, agg_shares: list[AggShare],
                num_measurements: int) -> AggResult:
        raise NotImplementedError()


def run_vdaf(vdaf: Vdaf[Measurement, AggParam, Any, Any, Any, Any,
                        AggResult, Any, Any, Any],
             verify_key: bytes,
             agg_param: AggParam,
             ctx: bytes,
             nonces: list[bytes],
             measurements: list[Measurement]) -> AggResult:
    """Run the full one-round VDAF protocol in-process."""
    assert len(nonces) == len(measurements)
    agg_shares = [vdaf.agg_init(agg_param) for _ in range(vdaf.SHARES)]
    for (nonce, measurement) in zip(nonces, measurements):
        rand = gen_rand(vdaf.RAND_SIZE)
        (public_share, input_shares) = \
            vdaf.shard(ctx, measurement, nonce, rand)

        prep_states = []
        outbound_prep_shares = []
        for agg_id in range(vdaf.SHARES):
            (state, share) = vdaf.prep_init(verify_key, ctx, agg_id,
                                            agg_param, nonce, public_share,
                                            input_shares[agg_id])
            prep_states.append(state)
            outbound_prep_shares.append(share)

        prep_msg = vdaf.prep_shares_to_prep(ctx, agg_param,
                                            outbound_prep_shares)
        for agg_id in range(vdaf.SHARES):
            out_share = vdaf.prep_next(ctx, prep_states[agg_id], prep_msg)
            agg_shares[agg_id] = vdaf.agg_update(agg_param,
                                                 agg_shares[agg_id],
                                                 out_share)
    return vdaf.unshard(agg_param, agg_shares, len(measurements))
