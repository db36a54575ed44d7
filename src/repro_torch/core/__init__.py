"""MRF network and QAT/int8 export."""
