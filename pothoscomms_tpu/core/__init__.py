"""Core streaming-dataflow runtime.

This subpackage is the the equivalent of the Pothos core framework
surface that the reference blocks consume (Pothos::Block, BufferChunk,
InputPort/OutputPort, Label, Packet, DType, BlockRegistry, signals/slots,
probes — see SURVEY.md §1 L0).
"""
