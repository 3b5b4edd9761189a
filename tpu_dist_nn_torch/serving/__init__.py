"""Wire-compatible gRPC serving of the reference's ``Process`` RPC.

Importing this package needs no grpcio: only :func:`serve_engine` and
:class:`GrpcClient` open sockets, and they import grpc when called.
"""

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
    make_process_handler,
    serve_engine,
)
from tpu_dist_nn_torch.serving.wire import (  # noqa: F401
    CLASS_HEADER,
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
