"""Backbones (lxmert) and the shared transformer blocks."""
