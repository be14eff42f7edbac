"""Host-side data layer (numpy): datasets, the CSR interaction index,
and the synthetic generators — copies of the reference's numpy code,
byte-equal for the same seeds."""
