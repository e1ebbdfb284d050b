"""TPC-DS model family: schema subset, seeded data generator, and the
query suite as SQL text.

Counterpart of ``spark_rapids_tpu/models/tpcds.py``: ``gen_tables`` draws
the same values from the same seed, and ``QUERIES`` holds the same text.

The reference validates against TPC-DS in its integration suite
(integration_tests/src/main/python/tpcds_test.py; BASELINE.md's AQE
north star is TPC-DS-shaped) — this module is the engine-native
equivalent: the 12 tables and the columns the query subset touches,
generated with seeded numpy at a scale factor (store_sales rows
cluster into per-ticket trips), plus adapted query text exercising the
TPC-DS-heavy features (multi-way star joins, rollup + grouping(),
windowed monthly/quarterly averages via CTEs, per-ticket trip counts,
scalar-subquery promo ratios, CASE, IN-lists).

Query text is adapted from the public TPC-DS specification queries,
constrained to this engine's SQL grammar (explicit JOIN ... ON, CTEs
instead of inline windowed aggregates).
"""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np
import pandas as pd

_BASE_DATE = datetime.date(1998, 1, 1)
_N_DAYS = 6 * 365  # 1998-01-01 .. 2003-12-29


def gen_tables(sf: float = 0.01, seed: int = 42) -> Dict[str, pd.DataFrame]:
    """Seeded star-schema subset at scale factor ``sf``
    (sf=0.01 -> ~6k store_sales rows; columns limited to the suite's
    needs, names and domains per the TPC-DS spec)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, pd.DataFrame] = {}

    # ---- date_dim: one row per calendar day -------------------------------
    days = np.arange(_N_DAYS)
    dates = np.array([_BASE_DATE + datetime.timedelta(days=int(d))
                      for d in days])
    out["date_dim"] = pd.DataFrame({
        "d_date_sk": 2450815 + days.astype(np.int64),
        "d_date": pd.to_datetime(dates),
        "d_year": np.array([d.year for d in dates], dtype=np.int64),
        "d_moy": np.array([d.month for d in dates], dtype=np.int64),
        "d_dom": np.array([d.day for d in dates], dtype=np.int64),
        "d_qoy": np.array([(d.month - 1) // 3 + 1 for d in dates],
                          dtype=np.int64),
        "d_month_seq": np.array(
            [(d.year - 1998) * 12 + d.month - 1 + 1189 for d in dates],
            dtype=np.int64),
        # weeks count from the Sunday on/before the base date (TPC-DS
        # weeks start Sunday; base 1998-01-01 was a Thursday -> offset 4)
        "d_week_seq": ((days + 4) // 7 + 5270).astype(np.int64),
        "d_day_name": np.array(
            [d.strftime("%A") for d in dates], dtype=object),
        "d_dow": np.array([(d.weekday() + 1) % 7 for d in dates],
                          dtype=np.int64),  # 0 = Sunday (TPC-DS)
    })

    # ---- time_dim: one row per minute of day ------------------------------
    mins = np.arange(24 * 60)
    out["time_dim"] = pd.DataFrame({
        "t_time_sk": mins.astype(np.int64),
        "t_hour": (mins // 60).astype(np.int64),
        "t_minute": (mins % 60).astype(np.int64),
    })

    # ---- item -------------------------------------------------------------
    n_item = max(int(200 * max(sf * 100, 1)), 60)
    isk = np.arange(1, n_item + 1)
    brand_id = rng.integers(1, 60, n_item) * 1000 + \
        rng.integers(1, 10, n_item)
    cats = np.array(["Books", "Electronics", "Home", "Jewelry", "Men",
                     "Music", "Shoes", "Sports", "Children", "Women"])
    cat_id = rng.integers(0, len(cats), n_item)
    classes = np.array(["accent", "bathroom", "bedding", "blinds",
                        "curtains", "decor", "fiction", "reference",
                        "self-help", "romance"])
    manufact_id = rng.integers(1, 200, n_item)
    manager_id = rng.integers(1, 40, n_item)
    # guarantee the suite's literal filters hit at every scale factor
    manufact_id[0:6] = 128          # q3
    manager_id[6:12] = 1            # q42 / q52
    manager_id[12:18] = 8           # q19
    manager_id[18:24] = 28          # q55
    out["item"] = pd.DataFrame({
        "i_item_sk": isk.astype(np.int64),
        "i_item_id": np.array([f"AAAAAAAA{k:08d}" for k in isk],
                              dtype=object),
        "i_product_name": np.array([f"product#{k}" for k in isk],
                                   dtype=object),
        "i_brand_id": brand_id.astype(np.int64),
        "i_brand": np.array([f"brand#{b}" for b in brand_id],
                            dtype=object),
        "i_class": classes[rng.integers(0, len(classes), n_item)],
        "i_category_id": (cat_id + 1).astype(np.int64),
        "i_category": cats[cat_id],
        "i_manufact_id": manufact_id.astype(np.int64),
        "i_manufact": np.array(
            [f"manufact#{m}" for m in manufact_id], dtype=object),
        "i_manager_id": manager_id.astype(np.int64),
        "i_current_price": (rng.integers(100, 9900, n_item) / 100.0),
        "i_item_desc": np.array(
            [f"desc of item {k}" for k in isk], dtype=object),
    })

    # ---- store ------------------------------------------------------------
    n_store = 6
    states = np.array(["TN", "SD", "AL", "GA", "MN", "NC"])
    out["store"] = pd.DataFrame({
        "s_store_sk": np.arange(1, n_store + 1, dtype=np.int64),
        "s_store_name": np.array(["ought", "able", "pri", "ese",
                                  "anti", "cally"], dtype=object),
        "s_state": states[:n_store],
        "s_city": np.array(["Midway", "Fairview", "Midway", "Oakland",
                            "Fairview", "Glendale"], dtype=object),
        "s_zip": np.array([f"{z:05d}" for z in
                           rng.integers(10000, 99999, n_store)],
                          dtype=object),
        "s_number_employees": rng.integers(200, 300,
                                           n_store).astype(np.int64),
    })

    # ---- customer_address / demographics ----------------------------------
    n_ca = max(int(300 * max(sf * 100, 1)), 100)
    cities = np.array(["Midway", "Fairview", "Oakland", "Glendale",
                       "Springdale", "Riverside", "Centerville",
                       "Pleasant Hill"])
    out["customer_address"] = pd.DataFrame({
        "ca_address_sk": np.arange(1, n_ca + 1, dtype=np.int64),
        "ca_state": states[rng.integers(0, len(states), n_ca)],
        "ca_city": cities[rng.integers(0, len(cities), n_ca)],
        "ca_zip": np.array([f"{z:05d}" for z in
                            rng.integers(10000, 99999, n_ca)],
                           dtype=object),
        "ca_country": np.array(["United States"] * n_ca, dtype=object),
    })
    genders = np.array(["M", "F"])
    marital = np.array(["S", "M", "D", "W", "U"])
    edu = np.array(["Primary", "Secondary", "College",
                    "2 yr Degree", "4 yr Degree", "Advanced Degree",
                    "Unknown"])
    n_cd = len(genders) * len(marital) * len(edu)
    gg, mm, ee = np.meshgrid(np.arange(2), np.arange(5), np.arange(7),
                             indexing="ij")
    out["customer_demographics"] = pd.DataFrame({
        "cd_demo_sk": np.arange(1, n_cd + 1, dtype=np.int64),
        "cd_gender": genders[gg.ravel()],
        "cd_marital_status": marital[mm.ravel()],
        "cd_education_status": edu[ee.ravel()],
    })
    n_hd = 50
    buy_pot = np.array(["0-500", "501-1000", "1001-5000", ">10000",
                        "Unknown"])
    out["household_demographics"] = pd.DataFrame({
        "hd_demo_sk": np.arange(1, n_hd + 1, dtype=np.int64),
        "hd_dep_count": rng.integers(0, 10, n_hd).astype(np.int64),
        "hd_vehicle_count": rng.integers(-1, 5, n_hd).astype(np.int64),
        "hd_buy_potential": buy_pot[rng.integers(0, len(buy_pot),
                                                 n_hd)],
    })

    # ---- customer ---------------------------------------------------------
    n_cust = max(int(500 * max(sf * 100, 1)), 200)
    out["customer"] = pd.DataFrame({
        "c_customer_sk": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_first_name": np.array(
            [f"First{i % 97}" for i in range(n_cust)], dtype=object),
        "c_last_name": np.array(
            [f"Last{i % 89}" for i in range(n_cust)], dtype=object),
        "c_salutation": np.array(["Mr.", "Ms.", "Dr.", "Mrs.", "Sir"]
                                 )[rng.integers(0, 5, n_cust)],
        "c_current_addr_sk": rng.integers(1, n_ca + 1,
                                          n_cust).astype(np.int64),
        "c_current_cdemo_sk": rng.integers(1, n_cd + 1,
                                           n_cust).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, n_hd + 1,
                                           n_cust).astype(np.int64),
        "c_birth_year": rng.integers(1920, 1995,
                                     n_cust).astype(np.int64),
    })

    # ---- promotion --------------------------------------------------------
    n_promo = 30
    yn = np.array(["Y", "N"])
    out["promotion"] = pd.DataFrame({
        "p_promo_sk": np.arange(1, n_promo + 1, dtype=np.int64),
        "p_channel_email": yn[rng.integers(0, 2, n_promo)],
        "p_channel_event": yn[rng.integers(0, 2, n_promo)],
    })

    # ---- store_sales (the fact table) -------------------------------------
    n_ss = max(int(600000 * sf), 1000)
    # rows cluster into TRIPS (one ticket number per trip, the TPC-DS
    # ss_ticket_number grain): items of a trip share the customer,
    # date, time, store, and demographics — q34/q73/q79 group by ticket
    n_trip = max(n_ss // 3, 1)
    trip_day = rng.integers(0, _N_DAYS, n_trip)
    # mild skews so the suite's joint filters (manager x november,
    # demographic-combo x state x year) keep hits at small scale
    # factors: 12% of trips in November, 10% on the (M, S, College)
    # demographics row, 15% of items pinned-attribute
    nov_days = np.array([i for i in range(_N_DAYS)
                         if (_BASE_DATE
                             + datetime.timedelta(days=i)).month == 11])
    nov = rng.random(n_trip) < 0.12
    trip_day[nov] = rng.choice(nov_days, int(nov.sum()))
    trip_cust = rng.integers(1, n_cust + 1, n_trip)
    trip_store = rng.integers(1, n_store + 1, n_trip)
    trip_hd = rng.integers(1, n_hd + 1, n_trip)
    trip_time = rng.integers(0, 24 * 60, n_trip)
    trip_cd = rng.integers(1, n_cd + 1, n_trip)
    target_cd = out["customer_demographics"]
    target_sk = int(target_cd[
        (target_cd.cd_gender == "M")
        & (target_cd.cd_marital_status == "S")
        & (target_cd.cd_education_status == "College")
    ]["cd_demo_sk"].iloc[0])
    trip_cd[rng.random(n_trip) < 0.10] = target_sk

    trip_of = rng.integers(0, n_trip, n_ss)
    day_off = trip_day[trip_of]
    cdemo_fk = trip_cd[trip_of]
    item_fk = rng.integers(1, n_item + 1, n_ss)
    pin = rng.random(n_ss) < 0.15
    item_fk[pin] = rng.integers(1, 25, int(pin.sum()))
    qty = rng.integers(1, 101, n_ss)
    list_price = rng.integers(100, 20000, n_ss) / 100.0
    pct = rng.integers(0, 101, n_ss) / 100.0
    sales_price = np.round(list_price * pct, 2)
    ext = np.round(sales_price * qty, 2)
    coupon = np.where(rng.random(n_ss) < 0.1,
                      np.round(ext * rng.random(n_ss) * 0.5, 2), 0.0)
    wholesale = np.round(list_price * 0.6, 2)
    # ~2% null store fks (q76's null-channel accounting; inner joins on
    # the store dim drop them identically in engine and oracle)
    store_fk = pd.array(trip_store[trip_of].astype(np.int64),
                        dtype="Int64")
    store_fk[rng.random(n_ss) < 0.02] = pd.NA
    # per-trip purchase address (q46/q68's bought-city vs current-city)
    trip_addr = rng.integers(1, n_ca + 1, n_trip)
    out["store_sales"] = pd.DataFrame({
        "ss_sold_date_sk": (2450815 + day_off).astype(np.int64),
        "ss_sold_time_sk": trip_time[trip_of].astype(np.int64),
        "ss_ticket_number": (trip_of + 1).astype(np.int64),
        "ss_item_sk": item_fk.astype(np.int64),
        "ss_customer_sk": trip_cust[trip_of].astype(np.int64),
        "ss_cdemo_sk": cdemo_fk.astype(np.int64),
        "ss_hdemo_sk": trip_hd[trip_of].astype(np.int64),
        "ss_addr_sk": trip_addr[trip_of].astype(np.int64),
        "ss_store_sk": store_fk,
        "ss_promo_sk": rng.integers(1, n_promo + 1,
                                    n_ss).astype(np.int64),
        "ss_quantity": qty.astype(np.int64),
        "ss_list_price": list_price,
        "ss_sales_price": sales_price,
        "ss_ext_sales_price": ext,
        "ss_coupon_amt": coupon,
        "ss_wholesale_cost": wholesale,
        "ss_net_profit": np.round(ext - wholesale * qty - coupon, 2),
    })

    # ---- reason / call_center / warehouse / ship_mode / web_page ----------
    out["reason"] = pd.DataFrame({
        "r_reason_sk": np.arange(1, 11, dtype=np.int64),
        "r_reason_desc": np.array(
            ["Package was damaged", "Stopped working",
             "Did not get it on time", "Not the product that was "
             "ordred", "Parts missing", "Does not work with a product "
             "that I have", "Gift exchange", "Did not like the color",
             "Did not like the model", "Did not fit"], dtype=object),
    })
    out["call_center"] = pd.DataFrame({
        "cc_call_center_sk": np.arange(1, 5, dtype=np.int64),
        "cc_name": np.array(["NY Metro", "Mid Atlantic",
                             "North Midwest", "Pacific NW"],
                            dtype=object),
        "cc_county": np.array(["Ziebach County"] * 4, dtype=object),
    })
    out["warehouse"] = pd.DataFrame({
        "w_warehouse_sk": np.arange(1, 6, dtype=np.int64),
        "w_warehouse_name": np.array(
            ["Conventional childr", "Important issues liv",
             "Doors canno", "Bad cards must make", "Rooms cook"],
            dtype=object),
        "w_warehouse_sq_ft": rng.integers(50000, 1000000,
                                          5).astype(np.int64),
        "w_state": states[rng.integers(0, len(states), 5)],
    })
    out["ship_mode"] = pd.DataFrame({
        "sm_ship_mode_sk": np.arange(1, 11, dtype=np.int64),
        "sm_type": np.array(["EXPRESS", "NEXT DAY", "OVERNIGHT",
                             "REGULAR", "TWO DAY"] * 2, dtype=object),
        "sm_code": np.array(["AIR", "SURFACE", "SEA", "AIR", "SURFACE",
                             "SEA", "AIR", "SURFACE", "SEA", "AIR"],
                            dtype=object),
    })
    out["web_page"] = pd.DataFrame({
        "wp_web_page_sk": np.arange(1, 21, dtype=np.int64),
        "wp_char_count": rng.integers(100, 8000, 20).astype(np.int64),
    })

    # ---- store_returns: ~9% of store_sales rows come back ------------------
    ret_of = np.flatnonzero(rng.random(n_ss) < 0.09)
    ss = out["store_sales"]
    ret_delta = rng.integers(1, 60, len(ret_of))
    ret_qty = np.minimum(qty[ret_of],
                         rng.integers(1, 101, len(ret_of)))
    ret_amt = np.round(sales_price[ret_of] * ret_qty, 2)
    out["store_returns"] = pd.DataFrame({
        "sr_returned_date_sk": np.minimum(
            ss["ss_sold_date_sk"].to_numpy()[ret_of] + ret_delta,
            2450815 + _N_DAYS - 1).astype(np.int64),
        "sr_item_sk": ss["ss_item_sk"].to_numpy()[ret_of],
        "sr_customer_sk": ss["ss_customer_sk"].to_numpy()[ret_of],
        "sr_ticket_number": ss["ss_ticket_number"].to_numpy()[ret_of],
        "sr_store_sk": ss["ss_store_sk"].to_numpy(
            dtype=np.float64, na_value=np.nan)[ret_of],
        "sr_reason_sk": rng.integers(1, 11,
                                     len(ret_of)).astype(np.int64),
        "sr_return_quantity": ret_qty.astype(np.int64),
        "sr_return_amt": ret_amt,
        "sr_net_loss": np.round(ret_amt * 0.1 + 5.0, 2),
    })
    out["store_returns"]["sr_store_sk"] = \
        out["store_returns"]["sr_store_sk"].astype("Int64")

    # ---- catalog_sales ----------------------------------------------------
    n_cs = max(int(n_ss * 0.5), 500)
    cs_day = rng.integers(0, _N_DAYS - 8, n_cs)
    cs_ship_addr = pd.array(rng.integers(1, n_ca + 1,
                                         n_cs).astype(np.int64),
                            dtype="Int64")
    cs_ship_addr[rng.random(n_cs) < 0.02] = pd.NA
    cs_qty = rng.integers(1, 101, n_cs)
    cs_list = rng.integers(100, 20000, n_cs) / 100.0
    cs_price = np.round(cs_list * (rng.integers(0, 101, n_cs) / 100.0),
                        2)
    cs_ext = np.round(cs_price * cs_qty, 2)
    cs_whole = np.round(cs_list * 0.6, 2)
    cs_item = rng.integers(1, n_item + 1, n_cs)
    pin2 = rng.random(n_cs) < 0.15
    cs_item[pin2] = rng.integers(1, 25, int(pin2.sum()))
    out["catalog_sales"] = pd.DataFrame({
        "cs_sold_date_sk": (2450815 + cs_day).astype(np.int64),
        "cs_ship_date_sk": (2450815 + cs_day +
                            rng.integers(1, 8, n_cs)).astype(np.int64),
        "cs_item_sk": cs_item.astype(np.int64),
        "cs_bill_customer_sk": rng.integers(1, n_cust + 1,
                                            n_cs).astype(np.int64),
        "cs_bill_cdemo_sk": np.where(
            rng.random(n_cs) < 0.10, target_sk,
            rng.integers(1, n_cd + 1, n_cs)).astype(np.int64),
        "cs_bill_addr_sk": rng.integers(1, n_ca + 1,
                                        n_cs).astype(np.int64),
        "cs_ship_addr_sk": cs_ship_addr,
        "cs_call_center_sk": rng.integers(1, 5, n_cs).astype(np.int64),
        "cs_ship_mode_sk": rng.integers(1, 11, n_cs).astype(np.int64),
        "cs_warehouse_sk": rng.integers(1, 6, n_cs).astype(np.int64),
        "cs_promo_sk": rng.integers(1, n_promo + 1,
                                    n_cs).astype(np.int64),
        "cs_quantity": cs_qty.astype(np.int64),
        "cs_list_price": cs_list,
        "cs_sales_price": cs_price,
        "cs_ext_sales_price": cs_ext,
        "cs_wholesale_cost": cs_whole,
        "cs_net_profit": np.round(cs_ext - cs_whole * cs_qty, 2),
    })

    # ---- web_sales --------------------------------------------------------
    n_ws = max(int(n_ss * 0.35), 400)
    ws_day = rng.integers(0, _N_DAYS, n_ws)
    ws_ship_cust = pd.array(rng.integers(1, n_cust + 1,
                                         n_ws).astype(np.int64),
                            dtype="Int64")
    ws_ship_cust[rng.random(n_ws) < 0.02] = pd.NA
    ws_qty = rng.integers(1, 101, n_ws)
    ws_list = rng.integers(100, 20000, n_ws) / 100.0
    ws_price = np.round(ws_list * (rng.integers(0, 101, n_ws) / 100.0),
                        2)
    ws_ext = np.round(ws_price * ws_qty, 2)
    ws_whole = np.round(ws_list * 0.6, 2)
    ws_item = rng.integers(1, n_item + 1, n_ws)
    pin3 = rng.random(n_ws) < 0.15
    ws_item[pin3] = rng.integers(1, 25, int(pin3.sum()))
    out["web_sales"] = pd.DataFrame({
        "ws_sold_date_sk": (2450815 + ws_day).astype(np.int64),
        "ws_sold_time_sk": rng.integers(0, 24 * 60,
                                        n_ws).astype(np.int64),
        "ws_item_sk": ws_item.astype(np.int64),
        "ws_bill_customer_sk": rng.integers(1, n_cust + 1,
                                            n_ws).astype(np.int64),
        "ws_bill_addr_sk": rng.integers(1, n_ca + 1,
                                        n_ws).astype(np.int64),
        "ws_ship_customer_sk": ws_ship_cust,
        "ws_web_page_sk": rng.integers(1, 21, n_ws).astype(np.int64),
        "ws_promo_sk": rng.integers(1, n_promo + 1,
                                    n_ws).astype(np.int64),
        "ws_quantity": ws_qty.astype(np.int64),
        "ws_list_price": ws_list,
        "ws_sales_price": ws_price,
        "ws_ext_sales_price": ws_ext,
        "ws_wholesale_cost": ws_whole,
        "ws_net_profit": np.round(ws_ext - ws_whole * ws_qty, 2),
    })
    return out


def load(session, data: Dict[str, pd.DataFrame]):
    """Create engine DataFrames + temp views for every table."""
    tables = {}
    for name, df in data.items():
        t = session.create_dataframe(df)
        t.createOrReplaceTempView(name)
        tables[name] = t
    return tables


# --------------------------------------------------------------- queries --

QUERIES: Dict[str, str] = {}

QUERIES["q3"] = """
select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss.ss_ext_sales_price) sum_agg
from store_sales ss
join date_dim dt on dt.d_date_sk = ss.ss_sold_date_sk
join item on ss.ss_item_sk = item.i_item_sk
where item.i_manufact_id = 128 and dt.d_moy = 11
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, sum_agg desc, brand_id
limit 100
"""

QUERIES["q7"] = """
select i.i_item_id,
       avg(ss.ss_quantity) agg1,
       avg(ss.ss_list_price) agg2,
       avg(ss.ss_coupon_amt) agg3,
       avg(ss.ss_sales_price) agg4
from store_sales ss
join customer_demographics cd on ss.ss_cdemo_sk = cd.cd_demo_sk
join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
join item i on ss.ss_item_sk = i.i_item_sk
join promotion p on ss.ss_promo_sk = p.p_promo_sk
where cd.cd_gender = 'M' and cd.cd_marital_status = 'S'
  and cd.cd_education_status = 'College'
  and (p.p_channel_email = 'N' or p.p_channel_event = 'N')
  and d.d_year = 2000
group by i.i_item_id
order by i.i_item_id
limit 100
"""

QUERIES["q19"] = """
select i.i_brand_id brand_id, i.i_brand brand, i.i_manufact_id,
       i.i_manufact, sum(ss.ss_ext_sales_price) ext_price
from store_sales ss
join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
join item i on ss.ss_item_sk = i.i_item_sk
join customer c on ss.ss_customer_sk = c.c_customer_sk
join customer_address ca on c.c_current_addr_sk = ca.ca_address_sk
join store s on ss.ss_store_sk = s.s_store_sk
where i.i_manager_id = 8 and d.d_moy = 11 and d.d_year = 1998
  and substr(ca.ca_zip, 1, 5) <> substr(s.s_zip, 1, 5)
group by i.i_brand_id, i.i_brand, i.i_manufact_id, i.i_manufact
order by ext_price desc, brand_id
limit 100
"""

QUERIES["q27"] = """
select i.i_item_id, s.s_state, grouping(s.s_state) g_state,
       avg(ss.ss_quantity) agg1,
       avg(ss.ss_list_price) agg2,
       avg(ss.ss_coupon_amt) agg3,
       avg(ss.ss_sales_price) agg4
from store_sales ss
join customer_demographics cd on ss.ss_cdemo_sk = cd.cd_demo_sk
join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
join store s on ss.ss_store_sk = s.s_store_sk
join item i on ss.ss_item_sk = i.i_item_sk
where cd.cd_gender = 'M' and cd.cd_marital_status = 'S'
  and cd.cd_education_status = 'College'
  and d.d_year = 2002 and s.s_state in ('TN', 'SD', 'AL')
group by rollup(i.i_item_id, s.s_state)
order by i.i_item_id, s.s_state
limit 100
"""

QUERIES["q42"] = """
select dt.d_year, item.i_category_id, item.i_category,
       sum(ss.ss_ext_sales_price) total
from store_sales ss
join date_dim dt on dt.d_date_sk = ss.ss_sold_date_sk
join item on ss.ss_item_sk = item.i_item_sk
where item.i_manager_id = 1 and dt.d_moy = 11 and dt.d_year = 2000
group by dt.d_year, item.i_category_id, item.i_category
order by total desc, dt.d_year, item.i_category_id, item.i_category
limit 100
"""

QUERIES["q52"] = """
select dt.d_year, item.i_brand_id brand_id, item.i_brand brand,
       sum(ss.ss_ext_sales_price) ext_price
from store_sales ss
join date_dim dt on dt.d_date_sk = ss.ss_sold_date_sk
join item on ss.ss_item_sk = item.i_item_sk
where item.i_manager_id = 1 and dt.d_moy = 11 and dt.d_year = 2000
group by dt.d_year, item.i_brand_id, item.i_brand
order by dt.d_year, ext_price desc, brand_id
limit 100
"""

QUERIES["q53"] = """
with quarterly as (
  select i.i_manufact_id, d.d_qoy,
         sum(ss.ss_sales_price) sum_sales
  from item i
  join store_sales ss on ss.ss_item_sk = i.i_item_sk
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  where d.d_year = 2001
    and i.i_category in ('Books', 'Home', 'Sports')
  group by i.i_manufact_id, d.d_qoy
)
select * from (
  select i_manufact_id, sum_sales,
         avg(sum_sales) over (partition by i_manufact_id)
           avg_quarterly_sales
  from quarterly
) t
where case when avg_quarterly_sales > 0
           then abs(sum_sales - avg_quarterly_sales)
                / avg_quarterly_sales
           else null end > 0.1
order by avg_quarterly_sales, sum_sales, i_manufact_id
limit 100
"""

QUERIES["q55"] = """
select i.i_brand_id brand_id, i.i_brand brand,
       sum(ss.ss_ext_sales_price) ext_price
from date_dim d
join store_sales ss on d.d_date_sk = ss.ss_sold_date_sk
join item i on ss.ss_item_sk = i.i_item_sk
where i.i_manager_id = 28 and d.d_moy = 11 and d.d_year = 1999
group by i.i_brand_id, i.i_brand
order by ext_price desc, brand_id
limit 100
"""

QUERIES["q96"] = """
select count(*) cnt
from store_sales ss
join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
join time_dim t on ss.ss_sold_time_sk = t.t_time_sk
join store s on ss.ss_store_sk = s.s_store_sk
where t.t_hour = 20 and t.t_minute >= 30
  and hd.hd_dep_count = 7 and s.s_store_name = 'ese'
"""

QUERIES["q98"] = """
with rev as (
  select i.i_item_id, i.i_category, i.i_class, i.i_current_price,
         sum(ss.ss_ext_sales_price) itemrevenue
  from store_sales ss
  join item i on ss.ss_item_sk = i.i_item_sk
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  where i.i_category in ('Sports', 'Books', 'Home')
    and d.d_year = 1999 and d.d_moy between 2 and 3
  group by i.i_item_id, i.i_category, i.i_class, i.i_current_price
)
select i_item_id, i_category, i_class, i_current_price, itemrevenue,
       itemrevenue * 100.0
         / sum(itemrevenue) over (partition by i_class) revenueratio
from rev
order by i_category, i_class, i_item_id, revenueratio
limit 100
"""

QUERIES["q34"] = """
with dn as (
  select ss.ss_ticket_number, ss.ss_customer_sk, count(*) cnt
  from store_sales ss
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  where (d.d_dom between 1 and 3 or d.d_dom between 25 and 28)
    and hd.hd_buy_potential = '>10000'
    and hd.hd_vehicle_count > 0
    and s.s_state in ('TN', 'SD', 'AL')
  group by ss.ss_ticket_number, ss.ss_customer_sk
)
select c.c_last_name, c.c_first_name, c.c_salutation,
       dn.ss_ticket_number, dn.cnt
from dn
join customer c on dn.ss_customer_sk = c.c_customer_sk
where dn.cnt between 2 and 6
order by c.c_last_name, c.c_first_name, dn.ss_ticket_number
limit 100
"""

QUERIES["q36"] = """
select sum(ss.ss_net_profit) / sum(ss.ss_ext_sales_price) gross_margin,
       i.i_category, i.i_class,
       grouping(i.i_category) + grouping(i.i_class) lochierarchy
from store_sales ss
join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
join item i on ss.ss_item_sk = i.i_item_sk
join store s on ss.ss_store_sk = s.s_store_sk
where d.d_year = 2001 and s.s_state in ('TN', 'SD', 'AL', 'GA')
group by rollup(i.i_category, i.i_class)
order by lochierarchy desc, i.i_category, i.i_class
limit 100
"""

QUERIES["q48"] = """
select sum(ss.ss_quantity) q
from store_sales ss
join store s on ss.ss_store_sk = s.s_store_sk
join customer_demographics cd on ss.ss_cdemo_sk = cd.cd_demo_sk
join customer c on ss.ss_customer_sk = c.c_customer_sk
join customer_address ca on c.c_current_addr_sk = ca.ca_address_sk
join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
where d.d_year = 2000
  and ((cd.cd_marital_status = 'M'
        and cd.cd_education_status = '4 yr Degree'
        and ss.ss_sales_price between 100.00 and 150.00)
    or (cd.cd_marital_status = 'D'
        and cd.cd_education_status = '2 yr Degree'
        and ss.ss_sales_price between 50.00 and 100.00)
    or (cd.cd_marital_status = 'S'
        and cd.cd_education_status = 'College'
        and ss.ss_sales_price between 150.00 and 200.00))
  and ((ca.ca_state in ('TN', 'SD', 'GA')
        and ss.ss_net_profit between 0 and 2000)
    or (ca.ca_state in ('AL', 'MN', 'NC')
        and ss.ss_net_profit between 150 and 3000))
"""

QUERIES["q61"] = """
select (select sum(ss.ss_ext_sales_price)
        from store_sales ss
        join promotion p on ss.ss_promo_sk = p.p_promo_sk
        join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
        where (p.p_channel_email = 'Y' or p.p_channel_event = 'Y')
          and d.d_year = 1998 and d.d_moy = 11) promotions,
       (select sum(ss.ss_ext_sales_price)
        from store_sales ss
        join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
        where d.d_year = 1998 and d.d_moy = 11) total,
       (select sum(ss.ss_ext_sales_price)
        from store_sales ss
        join promotion p on ss.ss_promo_sk = p.p_promo_sk
        join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
        where (p.p_channel_email = 'Y' or p.p_channel_event = 'Y')
          and d.d_year = 1998 and d.d_moy = 11) * 100.0 /
       (select sum(ss.ss_ext_sales_price)
        from store_sales ss
        join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
        where d.d_year = 1998 and d.d_moy = 11) ratio
"""

QUERIES["q65"] = """
with sa as (
  select ss.ss_store_sk, ss.ss_item_sk,
         sum(ss.ss_sales_price) revenue
  from store_sales ss
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  where d.d_month_seq between 1200 and 1211
  group by ss.ss_store_sk, ss.ss_item_sk
),
sb as (
  select ss_store_sk, avg(revenue) ave from sa group by ss_store_sk
)
select s.s_store_name, i.i_item_desc, sa.revenue, i.i_current_price,
       i.i_brand
from sa
join sb on sa.ss_store_sk = sb.ss_store_sk
join store s on sa.ss_store_sk = s.s_store_sk
join item i on sa.ss_item_sk = i.i_item_sk
where sa.revenue <= 0.1 * sb.ave
order by s.s_store_name, i.i_item_desc
limit 100
"""

QUERIES["q73"] = """
with dn as (
  select ss.ss_ticket_number, ss.ss_customer_sk, count(*) cnt
  from store_sales ss
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  where d.d_dom between 1 and 2
    and (hd.hd_buy_potential = '>10000'
         or hd.hd_buy_potential = 'Unknown')
    and hd.hd_vehicle_count > 0
    and s.s_city in ('Midway', 'Fairview')
  group by ss.ss_ticket_number, ss.ss_customer_sk
)
select c.c_last_name, c.c_first_name, c.c_salutation,
       dn.ss_ticket_number, dn.cnt
from dn
join customer c on dn.ss_customer_sk = c.c_customer_sk
where dn.cnt between 1 and 5
order by dn.cnt desc, c.c_last_name
limit 100
"""

QUERIES["q79"] = """
with pt as (
  select ss.ss_ticket_number, ss.ss_customer_sk, s.s_city,
         sum(ss.ss_coupon_amt) amt, sum(ss.ss_net_profit) profit
  from store_sales ss
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  where (hd.hd_dep_count = 7 or hd.hd_vehicle_count > 1)
    and d.d_dow = 1
    and d.d_year in (1998, 1999, 2000)
    and s.s_number_employees between 200 and 295
  group by ss.ss_ticket_number, ss.ss_customer_sk, s.s_city
)
select c.c_last_name, c.c_first_name,
       substr(pt.s_city, 1, 30) city, pt.ss_ticket_number, pt.amt,
       pt.profit
from pt
join customer c on pt.ss_customer_sk = c.c_customer_sk
order by c.c_last_name, c.c_first_name, city, pt.profit
limit 100
"""

QUERIES["q89"] = """
with msales as (
  select i.i_category, i.i_class, i.i_brand, s.s_store_name, d.d_moy,
         sum(ss.ss_sales_price) sum_sales
  from item i
  join store_sales ss on ss.ss_item_sk = i.i_item_sk
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  where d.d_year = 1999
    and i.i_category in ('Books', 'Electronics', 'Sports',
                         'Men', 'Jewelry', 'Women')
  group by i.i_category, i.i_class, i.i_brand, s.s_store_name, d.d_moy
)
select * from (
  select i_category, i_class, i_brand, s_store_name, d_moy, sum_sales,
         avg(sum_sales) over (partition by i_category, i_brand,
                              s_store_name) avg_monthly_sales
  from msales
) t
where case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name, d_moy
limit 100
"""

# ---- round-5 batch A: store-channel breadth -------------------------------

QUERIES["q43"] = """
select s.s_store_name,
       sum(case when d.d_day_name = 'Sunday'
                then ss.ss_sales_price else null end) sun_sales,
       sum(case when d.d_day_name = 'Monday'
                then ss.ss_sales_price else null end) mon_sales,
       sum(case when d.d_day_name = 'Tuesday'
                then ss.ss_sales_price else null end) tue_sales,
       sum(case when d.d_day_name = 'Wednesday'
                then ss.ss_sales_price else null end) wed_sales,
       sum(case when d.d_day_name = 'Thursday'
                then ss.ss_sales_price else null end) thu_sales,
       sum(case when d.d_day_name = 'Friday'
                then ss.ss_sales_price else null end) fri_sales,
       sum(case when d.d_day_name = 'Saturday'
                then ss.ss_sales_price else null end) sat_sales
from date_dim d
join store_sales ss on d.d_date_sk = ss.ss_sold_date_sk
join store s on ss.ss_store_sk = s.s_store_sk
where d.d_year = 2000
group by s.s_store_name
order by s.s_store_name
limit 100
"""

QUERIES["q44"] = """
with profits as (
  select ss.ss_item_sk item_sk, avg(ss.ss_net_profit) rank_col
  from store_sales ss
  where ss.ss_store_sk = 4
  group by ss.ss_item_sk
),
asceding as (
  select item_sk, rank() over (order by rank_col) rnk from profits
),
descending as (
  select item_sk, rank() over (order by rank_col desc) rnk
  from profits
)
select asceding.rnk,
       i1.i_product_name best_performing,
       i2.i_product_name worst_performing
from asceding
join descending on asceding.rnk = descending.rnk
join item i1 on i1.i_item_sk = asceding.item_sk
join item i2 on i2.i_item_sk = descending.item_sk
where asceding.rnk < 11
order by asceding.rnk
"""

QUERIES["q46"] = """
with dn as (
  select ss.ss_ticket_number, ss.ss_customer_sk,
         ca.ca_city bought_city,
         sum(ss.ss_coupon_amt) amt, sum(ss.ss_net_profit) profit
  from store_sales ss
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  join customer_address ca on ss.ss_addr_sk = ca.ca_address_sk
  where (hd.hd_dep_count = 7 or hd.hd_vehicle_count = 3)
    and d.d_dow in (6, 0)
    and d.d_year in (1999, 2000, 2001)
    and s.s_city in ('Fairview', 'Midway')
  group by ss.ss_ticket_number, ss.ss_customer_sk, ca.ca_city
)
select c.c_last_name, c.c_first_name, ca.ca_city current_city,
       dn.bought_city, dn.ss_ticket_number, dn.amt, dn.profit
from dn
join customer c on dn.ss_customer_sk = c.c_customer_sk
join customer_address ca on c.c_current_addr_sk = ca.ca_address_sk
where dn.bought_city <> ca.ca_city
order by c.c_last_name, c.c_first_name, ca.ca_city, dn.bought_city,
         dn.ss_ticket_number
limit 100
"""

QUERIES["q47"] = """
with v1 as (
  select i.i_category, i.i_brand, s.s_store_name,
         d.d_year, d.d_moy, sum(ss.ss_sales_price) sum_sales
  from item i
  join store_sales ss on ss.ss_item_sk = i.i_item_sk
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  where d.d_year = 2000
     or (d.d_year = 1999 and d.d_moy = 12)
     or (d.d_year = 2001 and d.d_moy = 1)
  group by i.i_category, i.i_brand, s.s_store_name, d.d_year, d.d_moy
),
v2 as (
  select i_category, i_brand, s_store_name, d_year, d_moy, sum_sales,
         avg(sum_sales) over (partition by i_category, i_brand,
                              s_store_name, d_year) avg_monthly_sales,
         lag(sum_sales, 1) over (partition by i_category, i_brand,
                                 s_store_name
                                 order by d_year, d_moy) psum,
         lead(sum_sales, 1) over (partition by i_category, i_brand,
                                  s_store_name
                                  order by d_year, d_moy) nsum
  from v1
)
select i_category, i_brand, s_store_name, d_year, d_moy, sum_sales,
       avg_monthly_sales, psum, nsum
from v2
where d_year = 2000 and avg_monthly_sales > 0
  and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by sum_sales - avg_monthly_sales, s_store_name, d_moy
limit 100
"""

QUERIES["q59"] = """
with wss as (
  select d.d_week_seq d_week_seq, ss.ss_store_sk ss_store_sk,
         sum(case when d.d_day_name = 'Sunday'
                  then ss.ss_sales_price else null end) sun_sales,
         sum(case when d.d_day_name = 'Monday'
                  then ss.ss_sales_price else null end) mon_sales,
         sum(case when d.d_day_name = 'Wednesday'
                  then ss.ss_sales_price else null end) wed_sales,
         sum(case when d.d_day_name = 'Friday'
                  then ss.ss_sales_price else null end) fri_sales
  from store_sales ss
  join date_dim d on d.d_date_sk = ss.ss_sold_date_sk
  group by d.d_week_seq, ss.ss_store_sk
)
select s.s_store_name s_store_name1, y.d_week_seq d_week_seq1,
       y.sun_sales / x.sun_sales sun_ratio,
       y.mon_sales / x.mon_sales mon_ratio,
       y.wed_sales / x.wed_sales wed_ratio,
       y.fri_sales / x.fri_sales fri_ratio
from wss y
join wss x on y.ss_store_sk = x.ss_store_sk
          and y.d_week_seq = x.d_week_seq - 52
join store s on y.ss_store_sk = s.s_store_sk
where y.d_week_seq between 5270 and 5322
order by s.s_store_name, y.d_week_seq
limit 100
"""

QUERIES["q63"] = """
with monthly as (
  select i.i_manager_id, d.d_moy, sum(ss.ss_sales_price) sum_sales
  from item i
  join store_sales ss on ss.ss_item_sk = i.i_item_sk
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  where d.d_year = 2001
    and i.i_category in ('Books', 'Children', 'Electronics')
  group by i.i_manager_id, d.d_moy
)
select i_manager_id, sum_sales, avg_monthly_sales
from (
  select i_manager_id, sum_sales,
         avg(sum_sales) over (partition by i_manager_id)
           avg_monthly_sales
  from monthly
) t
where case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales)
                / avg_monthly_sales
           else null end > 0.1
order by i_manager_id, avg_monthly_sales, sum_sales
limit 100
"""

QUERIES["q67"] = """
select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
       d_moy, s_store_name, sumsales, rk
from (
  select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_name, sumsales,
         rank() over (partition by i_category
                      order by sumsales desc) rk
  from (
    select i.i_category, i.i_class, i.i_brand, i.i_product_name,
           d.d_year, d.d_qoy, d.d_moy, s.s_store_name,
           sum(ss.ss_sales_price * ss.ss_quantity) sumsales
    from store_sales ss
    join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
    join store s on ss.ss_store_sk = s.s_store_sk
    join item i on ss.ss_item_sk = i.i_item_sk
    where d.d_month_seq between 1200 and 1211
    group by rollup(i.i_category, i.i_class, i.i_brand,
                    i.i_product_name, d.d_year, d.d_qoy, d.d_moy,
                    s.s_store_name)
  ) dw1
) dw2
where rk <= 3
order by i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_name, sumsales, rk
"""

QUERIES["q68"] = """
with dn as (
  select ss.ss_ticket_number, ss.ss_customer_sk,
         ca.ca_city bought_city,
         sum(ss.ss_ext_sales_price) extended_price,
         sum(ss.ss_coupon_amt) amt,
         sum(ss.ss_net_profit) profit
  from store_sales ss
  join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  join customer_address ca on ss.ss_addr_sk = ca.ca_address_sk
  where d.d_dom between 1 and 2
    and (hd.hd_dep_count = 7 or hd.hd_vehicle_count = 3)
    and d.d_year in (1998, 1999, 2000)
    and s.s_city in ('Midway', 'Fairview')
  group by ss.ss_ticket_number, ss.ss_customer_sk, ca.ca_city
)
select c.c_last_name, c.c_first_name, ca.ca_city current_city,
       dn.bought_city, dn.extended_price, dn.amt, dn.profit,
       dn.ss_ticket_number
from dn
join customer c on dn.ss_customer_sk = c.c_customer_sk
join customer_address ca on c.c_current_addr_sk = ca.ca_address_sk
where dn.bought_city <> ca.ca_city
order by c.c_last_name, dn.ss_ticket_number
limit 100
"""

QUERIES["q88"] = """
select
 (select count(*) from store_sales ss
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  join time_dim t on ss.ss_sold_time_sk = t.t_time_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  where t.t_hour = 8 and t.t_minute >= 30 and hd.hd_dep_count = 4
    and s.s_store_name = 'ese') h8_30_to_9,
 (select count(*) from store_sales ss
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  join time_dim t on ss.ss_sold_time_sk = t.t_time_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  where t.t_hour = 9 and t.t_minute < 30 and hd.hd_dep_count = 4
    and s.s_store_name = 'ese') h9_to_9_30,
 (select count(*) from store_sales ss
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  join time_dim t on ss.ss_sold_time_sk = t.t_time_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  where t.t_hour = 9 and t.t_minute >= 30 and hd.hd_dep_count = 4
    and s.s_store_name = 'ese') h9_30_to_10,
 (select count(*) from store_sales ss
  join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
  join time_dim t on ss.ss_sold_time_sk = t.t_time_sk
  join store s on ss.ss_store_sk = s.s_store_sk
  where t.t_hour = 10 and t.t_minute < 30 and hd.hd_dep_count = 4
    and s.s_store_name = 'ese') h10_to_10_30
"""

QUERIES["q13"] = """
select avg(ss.ss_quantity) a1, avg(ss.ss_ext_sales_price) a2,
       avg(ss.ss_wholesale_cost) a3, sum(ss.ss_wholesale_cost) s1
from store_sales ss
join store s on s.s_store_sk = ss.ss_store_sk
join customer_demographics cd on cd.cd_demo_sk = ss.ss_cdemo_sk
join household_demographics hd on ss.ss_hdemo_sk = hd.hd_demo_sk
join customer_address ca on ss.ss_addr_sk = ca.ca_address_sk
join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
where d.d_year = 2001
  and ((cd.cd_marital_status = 'M'
        and cd.cd_education_status = '4 yr Degree'
        and ss.ss_sales_price between 100.00 and 150.00
        and hd.hd_dep_count = 3)
    or (cd.cd_marital_status = 'S'
        and cd.cd_education_status = 'College'
        and ss.ss_sales_price between 50.00 and 100.00
        and hd.hd_dep_count = 1)
    or (cd.cd_marital_status = 'W'
        and cd.cd_education_status = '2 yr Degree'
        and ss.ss_sales_price between 150.00 and 200.00
        and hd.hd_dep_count = 1))
  and ((ca.ca_country = 'United States'
        and ca.ca_state in ('TN', 'SD', 'GA')
        and ss.ss_net_profit between 100 and 200)
    or (ca.ca_country = 'United States'
        and ca.ca_state in ('AL', 'MN', 'NC')
        and ss.ss_net_profit between 150 and 300)
    or (ca.ca_country = 'United States'
        and ca.ca_state in ('TN', 'MN', 'NC')
        and ss.ss_net_profit between 50 and 250))
"""

QUERIES["q6"] = """
with ia as (
  select i_category cat, avg(i_current_price) avg_price
  from item group by i_category
)
select ca.ca_state state, count(*) cnt
from customer_address ca
join customer c on ca.ca_address_sk = c.c_current_addr_sk
join store_sales ss on c.c_customer_sk = ss.ss_customer_sk
join date_dim d on ss.ss_sold_date_sk = d.d_date_sk
join item i on ss.ss_item_sk = i.i_item_sk
join ia on i.i_category = ia.cat
where d.d_year = 2001 and d.d_moy = 1
  and i.i_current_price > 1.2 * ia.avg_price
group by ca.ca_state
having count(*) >= 10
order by cnt, ca.ca_state
limit 100
"""
