"""Model zoo of the port: the symbol constructors ported so far."""
from . import resnet

__all__ = ['resnet']
