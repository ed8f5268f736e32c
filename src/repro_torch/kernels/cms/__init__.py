"""The count-min sketch update + query: plain versions, Hopper kernel and
wrapper."""
