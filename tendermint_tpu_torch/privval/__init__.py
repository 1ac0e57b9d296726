"""Validator signing (reference: privval/).

`FilePV` persists the key and — critically — the last-sign state
(height/round/step + signbytes + signature) BEFORE releasing any
signature, so a crash-restart can never double-sign (Go
privval/file.go:151,316; CheckHRS :94). The remote signer (signer.py:
SignerServer next to the key, SignerClient in the node) rides p2p's
SecretConnection."""

from .file_pv import FilePV, LastSignState, RemoteSignError
from .signer import SignerClient, SignerServer, serve_signer

__all__ = ["FilePV", "LastSignState", "RemoteSignError", "SignerClient",
           "SignerServer", "serve_signer"]
