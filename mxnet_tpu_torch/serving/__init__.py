"""Serving plane of the port: the dynamic batcher and the model server."""
from .batcher import DynamicBatcher, ServerOverloadedError
from .server import ModelNotFoundError, ModelServer

__all__ = ['DynamicBatcher', 'ServerOverloadedError', 'ModelServer',
           'ModelNotFoundError']
