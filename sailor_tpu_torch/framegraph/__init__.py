"""Frame graph: YAML asset, node registry, eager execution."""

from sailor_tpu_torch.framegraph import nodes  # noqa: F401  (registers the nodes)
from sailor_tpu_torch.framegraph.graph import (  # noqa: F401
    BaseNode,
    FrameGraph,
    FrameGraphAsset,
    RenderContext,
    node,
    node_types,
)
