"""The port's DAP message copy (janus_tpu_torch/messages) against the JAX
package's: the same values built in both packages encode to the same bytes,
and each package decodes the other's bytes back to its own value."""

import importlib

import pytest

SEED_BYTES = bytes(range(32))


def _build(pkg: str) -> dict:
    """name -> (message, extra decode args) for every DAP message type, built
    from fixed values with the modules of package ``pkg``."""
    M = importlib.import_module(f"{pkg}.messages")
    T = importlib.import_module(f"{pkg}.messages.taskprov")
    pp = importlib.import_module(f"{pkg}.vdaf.pingpong")
    tid = M.TaskId(SEED_BYTES)
    rid = M.ReportId(SEED_BYTES[:16])
    t = M.Time(1_600_002_000)
    iv = M.Interval(M.Time(1_600_000_000), M.Duration(3600))
    ct = M.HpkeCiphertext(7, b"\x01" * 32, b"payload bytes")
    meta = M.ReportMetadata(rid, t)
    share = M.ReportShare(meta, b"public", ct)
    init_msg = pp.PingPongMessage(pp.PingPongMessage.INITIALIZE, prep_share=b"\x05" * 40)
    fin_msg = pp.PingPongMessage(pp.PingPongMessage.FINISH, prep_msg=b"\x06" * 16)
    bid = M.BatchId(SEED_BYTES[::-1])
    ti = M.TimeInterval
    fs = M.FixedSize
    pbs_ti = M.PartialBatchSelector.new_time_interval()
    pbs_fs = M.PartialBatchSelector.new_fixed_size(bid)
    sel_ti = M.BatchSelector.new_time_interval(iv)
    sel_fs = M.BatchSelector.new_fixed_size(bid)
    config = M.HpkeConfig(
        3, M.HpkeKemId.X25519_HKDF_SHA256, M.HpkeKdfId.HKDF_SHA256, M.HpkeAeadId.AES_128_GCM,
        M.HpkePublicKey(b"\x09" * 32),
    )
    steps = [
        M.PrepareResp(rid, M.PrepareStepResult.new_continue(fin_msg)),
        M.PrepareResp(M.ReportId(SEED_BYTES[16:]), M.PrepareStepResult.finished()),
        M.PrepareResp(M.ReportId(b"\x00" * 16), M.PrepareStepResult.reject(M.PrepareError.VDAF_PREP_ERROR)),
    ]
    task_config = T.TaskConfig(
        b"task info",
        M.Url("https://leader.example/"),
        M.Url("https://helper.example/"),
        T.QueryConfig(M.Duration(3600), 1, 100, T.TaskprovQuery(T.TaskprovQuery.TIME_INTERVAL)),
        M.Time(1_700_000_000),
        T.VdafConfig(
            T.DpConfig(T.DpMechanism(T.DpMechanism.NONE)),
            T.VdafType(T.VdafType.PRIO3HISTOGRAM, length=1024, chunk_length=316),
        ),
    )
    return {
        "TaskId": (tid, ()),
        "ReportId": (rid, ()),
        "Duration": (M.Duration(3600), ()),
        "Time": (t, ()),
        "Interval": (iv, ()),
        "Url": (M.Url("https://helper.example/dap/"), ()),
        "Extension": (M.Extension(M.ExtensionType.TASKPROV, b"ext"), ()),
        "HpkeCiphertext": (ct, ()),
        "HpkeConfig": (config, ()),
        "HpkeConfigList": (M.HpkeConfigList([config, config]), ()),
        "ReportMetadata": (meta, ()),
        "PlaintextInputShare": (M.PlaintextInputShare([M.Extension(M.ExtensionType.TBD, b"")], b"share"), ()),
        "Report": (M.Report(meta, b"public", ct, M.HpkeCiphertext(8, b"\x02" * 32, b"helper")), ()),
        "InputShareAad": (M.InputShareAad(tid, meta, b"public"), ()),
        "Query[TimeInterval]": (M.Query.new_time_interval(iv), (ti,)),
        "Query[FixedSize]": (M.Query.new_fixed_size(M.FixedSizeQuery.by_batch_id(bid)), (fs,)),
        "CollectionReq": (M.CollectionReq(M.Query.new_time_interval(iv), b""), (ti,)),
        "Collection[TimeInterval]": (M.Collection(pbs_ti, 42, iv, ct, ct), (ti,)),
        "Collection[FixedSize]": (M.Collection(pbs_fs, 42, iv, ct, ct), (fs,)),
        "AggregateShareAad": (M.AggregateShareAad(tid, b"", sel_ti), (ti,)),
        "ReportShare": (share, ()),
        "PrepareInit": (M.PrepareInit(share, init_msg), ()),
        "PrepareContinue": (M.PrepareContinue(rid, fin_msg), ()),
        "AggregationJobInitializeReq": (M.AggregationJobInitializeReq(b"", pbs_ti, [M.PrepareInit(share, init_msg)] * 2), (ti,)),
        "AggregationJobContinueReq": (M.AggregationJobContinueReq(M.AggregationJobStep(1), [M.PrepareContinue(rid, fin_msg)]), ()),
        "AggregationJobResp": (M.AggregationJobResp(steps), ()),
        "AggregateShareReq": (M.AggregateShareReq(sel_fs, b"", 42, M.ReportIdChecksum(SEED_BYTES)), (fs,)),
        "AggregateShare": (M.AggregateShare(ct), ()),
        "TaskConfig": (task_config, ()),
    }


PORT = _build("janus_tpu_torch")
REFERENCE = _build("janus_tpu")


def _args(pkg: str, args: tuple) -> tuple:
    """The decode args (query types) as package ``pkg``'s own classes."""
    M = importlib.import_module(f"{pkg}.messages")
    return tuple(getattr(M, a.__name__) for a in args)


@pytest.mark.parametrize("name", sorted(PORT))
def test_message_encodes_and_decodes_like_the_reference(name):
    port, args = PORT[name]
    ref, _ = REFERENCE[name]
    assert type(port).__module__.startswith("janus_tpu_torch.")
    assert type(ref).__module__.startswith("janus_tpu.")
    wire = port.get_encoded()
    assert wire == ref.get_encoded(), name
    assert type(port).get_decoded(ref.get_encoded(), *_args("janus_tpu_torch", args)) == port
    assert type(ref).get_decoded(wire, *_args("janus_tpu", args)) == ref
