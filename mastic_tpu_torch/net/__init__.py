"""The network edge of the port: `transport.py` (the shaped link and
the reliable TCP / mutual-TLS transport the network parties speak)."""
