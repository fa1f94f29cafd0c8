"""Hand-written gRPC service plumbing.

The image has no ``grpc_tools`` protoc plugin, so instead of generated
``*_pb2_grpc.py`` modules we declare each service's method table once and
derive both the client stub and the server registration from it.  This plays
the role of the generated service code in the reference
(elasticai_api/proto/elasticai_api.proto:96-105,
elasticdl/proto/elasticdl.proto:41-86).
"""

import grpc

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import tracing


class RawFrame:
    """Identity codec for raw-frame RPC slots (docs/ps_pipeline.md
    "Frame wire"): the serialized gRPC message IS the tensor_codec
    frame blob.  Registered in a method table exactly like a protobuf
    class — ``SerializeToString``/``FromString`` are the only contract
    the stub/servicer plumbing below uses — but both are the identity,
    so no protobuf envelope ever touches the hot payload and the
    receiver's ``decode_frame`` views alias the wire bytes directly."""

    @staticmethod
    def SerializeToString(data):  # noqa: N802 — protobuf API shape
        return bytes(data)

    @staticmethod
    def FromString(data):  # noqa: N802 — protobuf API shape
        return data


# service name -> {method name: (request class, response class)}
SERVICES = {
    "elasticdl_tpu.Master": {
        "get_task": (pb.GetTaskRequest, pb.GetTaskResponse),
        "report_task_result": (pb.ReportTaskResultRequest, pb.Empty),
        "report_batch_done": (pb.ReportBatchDoneRequest, pb.Empty),
        "get_comm_rank": (pb.GetCommRankRequest, pb.GetCommRankResponse),
        "report_train_loop_status": (pb.ReportTrainLoopStatusRequest, pb.Empty),
        "report_evaluation_metrics": (pb.ReportEvaluationMetricsRequest, pb.Empty),
        "report_version": (pb.ReportVersionRequest, pb.Empty),
        "report_training_params": (pb.ReportTrainingParamsRequest, pb.Empty),
    },
    "elasticdl_tpu.PServer": {
        "push_model": (pb.ModelPB, pb.Empty),
        "push_embedding_table_infos": (pb.ModelPB, pb.Empty),
        "pull_dense_parameters": (
            pb.PullDenseParametersRequest,
            pb.PullDenseParametersResponse,
        ),
        "pull_embedding_vectors": (pb.PullEmbeddingVectorsRequest, pb.TensorPB),
        "push_gradients": (pb.PushGradientsRequest, pb.PushGradientsResponse),
        # Frame-native data plane (negotiated via
        # PullDenseParametersResponse.frame_capable, per-shard): the
        # request/response frame slots use the RawFrame identity codec,
        # so the gradient table / dense params ride as ONE zero-copy
        # frame blob per RPC.  Generation fencing reads the frame
        # header's meta, so a dead incarnation's push is still rejected
        # before any payload decode.
        "push_gradients_frame": (RawFrame, pb.PushGradientsResponse),
        "pull_dense_parameters_frame": (
            pb.PullDenseParametersRequest,
            RawFrame,
        ),
        "prepare_gradients": (
            pb.PrepareGradientsRequest,
            pb.PushGradientsResponse,
        ),
        "commit_gradients": (
            pb.CommitGradientsRequest,
            pb.PushGradientsResponse,
        ),
    },
}


class _TracedMultiCallable:
    """Wraps one unary-unary multicallable with trace-context
    propagation (utils/tracing.py): the blocking form runs inside a
    ``rpc.client`` span; both forms inject the caller's (trace, span)
    ids as gRPC metadata so the server-side interceptor links its span
    to ours.  ``.future`` is preserved for the PS client's fan-out
    (the async completion records an instant event, not a span — its
    end is observed on another thread via ``.result()``)."""

    __slots__ = ("_call", "_name", "_tracer")

    def __init__(self, call, name, tracer):
        self._call = call
        self._name = name
        self._tracer = tracer

    def __call__(self, request, timeout=None, metadata=None, **kwargs):
        if not self._tracer.enabled:
            return self._call(request, timeout=timeout,
                              metadata=metadata, **kwargs)
        with self._tracer.span("rpc.client/%s" % self._name,
                               kind="client"):
            return self._call(
                request, timeout=timeout,
                metadata=self._tracer.inject(metadata), **kwargs
            )

    def future(self, request, timeout=None, metadata=None, **kwargs):
        if not self._tracer.enabled:
            return self._call.future(request, timeout=timeout,
                                     metadata=metadata, **kwargs)
        self._tracer.event("rpc.client_async/%s" % self._name)
        return self._call.future(
            request, timeout=timeout,
            metadata=self._tracer.inject(metadata), **kwargs
        )


def _make_stub_class(service_name):
    methods = SERVICES[service_name]

    class Stub:
        def __init__(self, channel):
            tracer = tracing.default_tracer()
            for name, (req_cls, res_cls) in methods.items():
                setattr(
                    self,
                    name,
                    _TracedMultiCallable(
                        channel.unary_unary(
                            "/%s/%s" % (service_name, name),
                            request_serializer=req_cls.SerializeToString,
                            response_deserializer=res_cls.FromString,
                        ),
                        name,
                        tracer,
                    ),
                )

    Stub.__name__ = service_name.split(".")[-1] + "Stub"
    return Stub


MasterStub = _make_stub_class("elasticdl_tpu.Master")
PServerStub = _make_stub_class("elasticdl_tpu.PServer")


def _add_servicer(service_name, servicer, server):
    handlers = {}
    for name, (req_cls, res_cls) in SERVICES[service_name].items():
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=res_cls.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_name, handlers),)
    )


def add_master_servicer(servicer, server):
    _add_servicer("elasticdl_tpu.Master", servicer, server)


def add_pserver_servicer(servicer, server):
    _add_servicer("elasticdl_tpu.PServer", servicer, server)
