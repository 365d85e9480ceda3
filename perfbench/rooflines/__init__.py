"""Bytes and operations of each kernel, from its launch shapes."""
