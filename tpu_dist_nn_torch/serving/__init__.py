"""Wire-compatible gRPC serving: the reference's ``Process`` RPC, and
LM generation (``Generate``, ``GenerateStream``) behind the continuous
decode scheduler.

Importing this package needs no grpcio: only :func:`serve_engine`,
:func:`serve_lm_generate` and :class:`GrpcClient` open sockets, and they
import grpc when called.
"""

from tpu_dist_nn_torch.serving.continuous import (  # noqa: F401
    ContinuousScheduler,
)

from tpu_dist_nn_torch.serving.resilience import (  # noqa: F401
    CircuitBreaker,
    GracefulDrain,
    RetryPolicy,
)
from tpu_dist_nn_torch.serving.sched_core import (  # noqa: F401
    DEFAULT_CLASS_WATERMARKS,
    SLO_CLASSES,
    SchedCore,
    normalize_class,
    validate_class_watermarks,
)
from tpu_dist_nn_torch.serving.server import (  # noqa: F401
    Batcher,
    GrpcClient,
    RpcAbort,
    StreamReply,
    make_generate_handler,
    make_generate_stream_handler,
    make_process_handler,
    serve_engine,
    serve_lm_generate,
)
from tpu_dist_nn_torch.serving.wire import (  # noqa: F401
    CLASS_HEADER,
    GENERATE_METHOD,
    GENERATE_STREAM_METHOD,
    PROCESS_METHOD,
    RETRY_AFTER_HEADER,
    SERVICE_NAME,
    SESSION_HEADER,
    WireMatrix,
    decode_matrix,
    decode_matrix_into,
    decode_matrix_lazy,
    encode_matrix,
)
