"""Validator signing (reference: privval/).

`FilePV` persists the key and — critically — the last-sign state
(height/round/step + signbytes + signature) BEFORE releasing any
signature, so a crash-restart can never double-sign (Go
privval/file.go:151,316; CheckHRS :94). The reference's remote signer
(signer.py) rides p2p's SecretConnection and comes with the p2p port."""

from .file_pv import FilePV, LastSignState, RemoteSignError

__all__ = ["FilePV", "LastSignState", "RemoteSignError"]
