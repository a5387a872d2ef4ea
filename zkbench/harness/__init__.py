"""The benchmark's own machinery: the specification and its lookups, the
window's arithmetic, the device trace, the proof comparison and the
module isolation check."""
