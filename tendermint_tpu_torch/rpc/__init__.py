"""JSON-RPC over HTTP, URI and WebSocket (reference: rpc/; Go rpc/).

jsonrpc.py is the server and its clients, core.py the node's routes.
The gRPC broadcast API is not ported (ROADMAP Queue A item 9)."""
