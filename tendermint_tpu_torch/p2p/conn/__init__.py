from .connection import ChannelStatus, MConnConfig, MConnection
from .secret_connection import SecretConnection, make_secret_connection

__all__ = [
    "MConnection", "MConnConfig", "ChannelStatus",
    "SecretConnection", "make_secret_connection",
]
